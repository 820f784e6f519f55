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
the processes during ``backward``.

:class:`MeshStrategy` and :class:`FSDPStrategy` take the same protocol
over a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``parallel/mesh.py``): parameters replicated over the data and sequence
axes have their gradients summed over ``dp``×``fsdp``×``sp`` after the
backward, parameters that the partition rules (or FSDP's own rule) shard
over ``fsdp`` live as FSDP2 (``fully_shard``) shards, and the reported
loss is the global mean.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel import sharding as sh
from tensorflowonspark_tpu_torch.parallel.mesh import MeshSpec, group_over, make_mesh
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

    def state_dict(self) -> dict:
        """``{"model", "optim", "step", "extras"}`` for a
        ``CheckpointManager``: the unwrapped model's state dict (parameters
        and buffers) and the optimizer's keyed by parameter name
        (``torch.distributed.checkpoint.state_dict.get_state_dict``), so a
        checkpoint restores into a fresh replica on any device.  The
        tensors are the live ones, not copies."""
        from torch.distributed.checkpoint.state_dict import get_state_dict

        model_sd, optim_sd = get_state_dict(self.module, self.optimizer)
        return {"model": model_sd, "optim": optim_sd, "step": self.step,
                "extras": self.extras}

    def load_state_dict(self, saved: dict) -> None:
        """Load :meth:`state_dict`'s layout (e.g. a restored checkpoint,
        on any device) into the model, optimizer, step and extras."""
        from torch.distributed.checkpoint.state_dict import set_state_dict

        # a checkpoint drops empty containers: an optimizer without state
        # (plain SGD) restores without its "state" key, a state without
        # extras without "extras"
        set_state_dict(self.module, self.optimizer, model_state_dict=saved["model"],
                       optim_state_dict={"state": {}, **saved["optim"]})
        self.step = int(saved["step"])
        self.extras = dict(saved.get("extras") or {})


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


class _LocalStepStrategy:
    """What every strategy of the port shares: each process trains on its
    own batch on ``device`` and steps its own optimizer.  Subclasses say
    how the model is placed (:meth:`init_state`) and how gradients and the
    loss are reduced over the processes (the ``_loss_scale``,
    :meth:`_reduce_gradients` and :meth:`_reduce_loss` hooks)."""

    def __init__(self, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.seed = int(seed)

    #: the loss is multiplied by this before its backward
    _loss_scale = 1.0

    def _reduce_gradients(self, model: nn.Module) -> None:
        """Combine the processes' gradients after the backward."""

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss to report, from this process's (detached) loss."""
        return loss

    # -- data --------------------------------------------------------------
    def shard_batch(self, batch):
        """This process's batch (numpy arrays or tensors, nested in
        tuples/lists/dicts) as tensors on the device.

        Each process keeps its local batch and the strategy combines the
        gradients of the local losses (DDP averages them).  That is the JAX
        strategy's gradient of the mean over the global sharded batch when
        every process's batch has the same size."""
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
                (loss * self._loss_scale).backward()
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
                        (loss_i * (self._loss_scale / accum_steps)).backward()
                    total += loss_i.detach()
                loss = total / accum_steps
            self._reduce_gradients(state.model)
            state.optimizer.step()
            state.step += 1
            state.extras = extras
            return state, {"loss": self._reduce_loss(loss), **aux}

        return step


class DataParallelStrategy(_LocalStepStrategy):
    """Synchronous data parallelism: one model replica per process.

    The reference's ``MultiWorkerMirroredStrategy``.  ``device`` is where
    this process's replica lives (``None``: the card, raising without
    one); ``seed`` is the base of the per-step generators handed to a
    ``loss_fn`` that takes ``rng``.
    """

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


# tf.distribute-parity alias: the strategy name reference users know.
MultiWorkerMirroredStrategy = DataParallelStrategy


def _coalesced(tensors: list, fn) -> None:
    """Run the in-place collective ``fn`` on ``tensors`` as one flat buffer
    a dtype (one call instead of one a tensor), copying the results back."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


class MeshStrategy(_LocalStepStrategy):
    """Training over an explicit mesh: the JAX package's ``MeshStrategy``.

    ``mesh`` is a :func:`~.mesh.make_mesh` mesh (built from ``axis_sizes``
    over every rank when absent, on ``device``'s type).  Every rank holds
    the whole model except for the parameters that ``rules``
    (:class:`~.sharding.PartitionRules` over the parameter names) shard
    over ``fsdp``: those become FSDP2 shards (``fully_shard`` over the
    mesh's ``fsdp`` axis, ``dp`` × ``fsdp`` when both are larger than 1).
    Specs naming another axis raise: tensor parallelism goes through
    :func:`~.transformer.make_transformer_stage`.

    Each rank's ``loss_fn`` sees its own batch: its ``dp``×``fsdp`` rows
    and, under ``sp``, its block of the sequence (:meth:`sequence_block`,
    :meth:`sequence_offset`).  Its loss must be such that the mean over
    the ranks is the global loss (a local mean over equal local batches
    is; a sequence block's token-loss sum over the global token count
    divided by the number of ranks is).  The step backprops ``loss /
    n``, sums the gradients of every replicated parameter over the ``n``
    ranks of ``dp``×``fsdp``×``sp`` (:attr:`grad_axes`), and reports that
    mean; ``tp`` ranks are not summed (their tensor-parallel shards are
    their own, and the transformer stage's conjugate collectives already
    complete the replicated parameters' gradients).
    """

    #: the axes over which the gradients of replicated parameters are summed
    grad_axes = ("dp", "fsdp", "sp")

    def __init__(self, mesh=None, rules: sh.PartitionRules | None = None, seed: int = 0,
                 device=None, **axis_sizes):
        super().__init__(device, seed)
        self.mesh = mesh if mesh is not None else make_mesh(
            device_type=self.device.type, **axis_sizes)
        self.rules = rules
        self._grad_group = group_over(self.mesh, self.grad_axes)
        self._n = comm.group_size(self._grad_group)
        self._loss_scale = 1.0 / self._n
        self._replicated: list = []
        self._sharded: list = []
        self._fsdp_count = 1
        self._sp = self.axis_size("sp")

    def axis_size(self, axis: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def num_replicas_in_sync(self) -> int:
        """tf.distribute parity: total data-parallel degree."""
        return self.axis_size("dp") * self.axis_size("fsdp")

    # -- state -------------------------------------------------------------
    def _fsdp_placements(self, model: nn.Module) -> dict:
        """``{parameter: Shard(dim)}`` for the parameters the rules shard
        over ``fsdp``; a spec naming any other axis raises."""
        from torch.distributed.tensor import Shard

        if self.rules is None:
            return {}
        params = dict(model.named_parameters())
        out = {}
        for name, spec in self.rules.tree_specs(params).items():
            axes = {a for entry in spec for a in sh._axes_of(entry)}
            if axes - {"fsdp"}:
                raise NotImplementedError(
                    f"{name}: spec {spec!r} names {sorted(axes - {'fsdp'})}; MeshStrategy "
                    "places parameters over 'fsdp' only (tensor-parallel layers: "
                    "parallel.transformer.make_transformer_stage)")
            if axes:
                out[params[name]] = Shard(next(d for d, e in enumerate(spec)
                                               if "fsdp" in sh._axes_of(e)))
        return out

    def init_state(self, model_or_fn, optimizer_fn) -> TrainState:
        """Move the model (or the one ``model_or_fn()`` builds) to the
        device, give every rank the first rank's parameters and buffers,
        shard what the rules shard (FSDP2), and build the optimizer with
        ``optimizer_fn(parameters)`` (its state follows each parameter's
        placement)."""
        model = model_or_fn if isinstance(model_or_fn, nn.Module) else model_or_fn()
        model = model.to(self.device)
        if _world_size() > 1:
            src = int(self.mesh.mesh.flatten()[0])
            with torch.no_grad():
                _coalesced(list(model.parameters()) + list(model.buffers()),
                           lambda flat: dist.broadcast(flat, src))
        placements = self._fsdp_placements(model)
        self._replicated = [p for p in model.parameters() if p not in placements]
        if placements:
            from torch.distributed.fsdp import fully_shard

            if self._sp > 1 or self.axis_size("tp") > 1:
                raise NotImplementedError("fsdp-sharded parameters with sp or tp > 1 "
                                          "are not supported")
            axes = ("dp", "fsdp") if self.axis_size("dp") > 1 else ("fsdp",)
            fully_shard(model, mesh=self.mesh[axes],
                        shard_placement_fn=lambda p: placements.get(p),
                        ignored_params=set(self._replicated) or None)
            # FSDP averages its shards' gradients over these ranks (a divide
            # factor of 1 would need PREMUL_SUM, which gloo lacks); the step
            # sums, so they are scaled back by the count after the backward
            self._fsdp_count = math.prod(self.axis_size(a) for a in axes)
            # fully_shard put new (DTensor) parameters in place of the old
            kept = {id(p) for p in self._replicated}
            self._sharded = [p for p in model.parameters() if id(p) not in kept]
        return TrainState(model=model, optimizer=optimizer_fn(model.parameters()))

    # -- step --------------------------------------------------------------
    def _reduce_gradients(self, model: nn.Module) -> None:
        grads = [p.grad for p in self._replicated if p.grad is not None]
        if grads and self._n > 1:
            _coalesced(grads, lambda flat: comm.all_reduce(flat, self._grad_group))
        with torch.no_grad():
            for p in self._sharded:
                if p.grad is not None:
                    p.grad.mul_(self._fsdp_count)

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(loss * self._loss_scale, self._grad_group)

    # -- data --------------------------------------------------------------
    def batch_sharding(self) -> list:
        """DTensor placements of a batch over the mesh (dim 0 over dp×fsdp)."""
        return sh.named_sharding(self.mesh, *sh.batch_pspec())

    def sequence_block(self, x, dim: int = 1):
        """This rank's block of ``x`` along its sequence ``dim``, cut over
        ``sp`` (``x`` itself when ``sp`` is 1)."""
        if self._sp == 1:
            return x
        if x.shape[dim] % self._sp:
            raise ValueError(f"sequence length {x.shape[dim]} does not split over "
                             f"sp={self._sp}")
        return x.chunk(self._sp, dim=dim)[self.mesh.get_local_rank("sp")]

    def sequence_offset(self, seq_len: int) -> int:
        """The global position of this rank's first token in a sequence of
        ``seq_len`` cut over ``sp``."""
        return self.mesh.get_local_rank("sp") * (seq_len // self._sp)

    def anchor_activations(self, x):
        """The JAX package pins activations to the data axes so that XLA's
        propagation does not shard them like the weights.  Eager PyTorch
        keeps each rank's activations as its own block, with nothing to
        propagate: the tree comes back as it is."""
        return x

    def run(self, fn, *args):
        """``fn(*args)``: in the JAX package, under the mesh's context."""
        return fn(*args)


class FSDPStrategy(MeshStrategy):
    """Data parallelism with parameters fully sharded over the same ranks:
    the mesh is ``fsdp`` over every rank, and each parameter of at least
    ``min_shard_size`` elements is sharded (FSDP2) on its first dimension
    that divides by the axis size; smaller ones stay replicated."""

    def __init__(self, devices=None, min_shard_size: int = 2 ** 12, device=None,
                 seed: int = 0):
        device = resolve_device(device)
        mesh = make_mesh(MeshSpec(dp=1, fsdp=-1), devices=devices, device_type=device.type)
        super().__init__(mesh=mesh, rules=_fsdp_rules(mesh, min_shard_size), seed=seed,
                         device=device)
        self.min_shard_size = min_shard_size


def _fsdp_rules(mesh, min_shard_size: int) -> sh.PartitionRules:
    """Shard every large-enough parameter on its first divisible axis."""

    class _AutoFSDP(sh.PartitionRules):
        def __init__(self):
            self.n = mesh.size(mesh.mesh_dim_names.index("fsdp"))

        def tree_specs(self, params):
            def spec_for_leaf(leaf):
                shape = tuple(getattr(leaf, "shape", ()))
                if math.prod(shape) < min_shard_size:
                    return sh.P()
                for dim, extent in enumerate(shape):
                    if extent % self.n == 0 and extent >= self.n:
                        parts = [None] * len(shape)
                        parts[dim] = "fsdp"
                        return sh.P(*parts)
                return sh.P()

            return {name: spec_for_leaf(leaf) for name, leaf in params.items()}

    return _AutoFSDP()


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


@dataclasses.dataclass(frozen=True)
class exponential_decay:  # noqa: N801 (optax's name)
    """``optax.exponential_decay(init_value, transition_steps, decay_rate)``:
    ``count -> init_value * decay_rate ** (count / transition_steps)``, not
    staircase; ``count`` is 0 at the first update.  A plain value, so an
    optimizer's checkpoint holds it."""

    init_value: float
    transition_steps: int
    decay_rate: float

    def __post_init__(self):
        if self.transition_steps <= 0:
            raise ValueError(f"transition_steps must be > 0, got {self.transition_steps}")

    def __call__(self, count: int) -> float:
        return self.init_value * self.decay_rate ** (count / self.transition_steps)


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``: the
    accumulator starts at ``initial_accumulator_value`` (0.1), gains ``g^2``
    each step, and the step is ``-lr * g * rsqrt(acc + eps)`` with ``eps``
    (1e-7) inside the root, 0 where ``acc`` is 0.  (``torch.optim.Adagrad``
    starts at 0 and adds its eps outside the root.)"""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, {"lr": lr, "initial_accumulator_value":
                                  initial_accumulator_value, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc, g = state["sum_of_squares"], p.grad
                acc.addcmul_(g, g)
                scale = (acc + group["eps"]).rsqrt_()
                if group["initial_accumulator_value"] <= 0:
                    scale.masked_fill_(acc <= 0, 0.0)
                p.add_(scale.mul_(g), alpha=-group["lr"])


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(learning_rate, decay, eps, momentum=m)``: ``nu =
    decay * nu + (1 - decay) * g^2`` from 0, the update ``g * rsqrt(nu +
    eps)`` (eps inside the root) scaled by ``-lr(count)``, then the trace
    ``t = update + m * t`` applied.  The scheduled rate sits inside the
    momentum buffer; ``torch.optim.RMSprop`` adds eps outside the root and
    applies ``lr`` after the momentum.  ``lr`` is a number or a schedule
    ``count -> rate`` (:func:`exponential_decay`), ``count`` the updates
    made before this one."""

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float | None = None):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps,
                                  "momentum": momentum})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["count"] = torch.zeros((), dtype=torch.int64)
                    state["nu"] = torch.zeros_like(p)
                    if group["momentum"] is not None:
                        state["trace"] = torch.zeros_like(p)
                count = int(state["count"])
                rate = lr(count) if callable(lr) else lr
                g, nu = p.grad, state["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g, value=1 - group["decay"])
                update = (nu + group["eps"]).rsqrt_().mul_(g).mul_(-rate)
                if group["momentum"] is not None:
                    update = state["trace"].mul_(group["momentum"]).add_(update)
                p.add_(update)
                state["count"] = torch.tensor(count + 1, dtype=torch.int64)


def adagrad(lr: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    """``optax.adagrad(lr)`` as ``optimizer_fn`` (:class:`OptaxAdagrad`)."""
    return lambda params: OptaxAdagrad(params, lr, initial_accumulator_value, eps)


def rmsprop(lr, decay: float = 0.9, eps: float = 1e-8, momentum: float | None = None):
    """``optax.rmsprop(lr, decay, eps, momentum=momentum)`` as
    ``optimizer_fn`` (:class:`OptaxRMSprop`); ``lr`` may be a schedule."""
    return lambda params: OptaxRMSprop(params, lr, decay, eps, momentum)


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
