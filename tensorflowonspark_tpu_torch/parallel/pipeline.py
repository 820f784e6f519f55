"""Pipeline parallelism: microbatched execution over the ``pp`` axis.

Port of ``tensorflowonspark_tpu/parallel/pipeline.py``.  The model's
repeated trunk is one ``stage_fn(params, x) -> y`` over a *stacked*
parameter tree whose leaves carry a leading stage axis
(:func:`stack_stage_params`, spec :func:`pipeline_spec`); each ``pp`` rank
holds its own block of it (:func:`~.sharding.local_block`), microbatches
stream through the stages, and each tick's activations move one stage on
by a point-to-point hop over the ``pp`` group (:func:`~.comm.shift`, the
JAX package's circular ``ppermute``).

Two schedules share the layout, as in the JAX package:

- :func:`pipeline_apply` — GPipe: ``M + S - 1`` ticks forward.  It is
  differentiable, but not by tracing the hops through autograd: eager
  autograd runs a node's backward only where its output reached the loss,
  and a stage that ignores what it receives (stage 0, a fill or drain
  tick) would leave its half of a hop unrun while its neighbour waits.  So
  the schedule is one ``autograd.Function`` whose backward runs the
  reverse schedule explicitly, a hop every tick on every rank.  With
  ``remat`` each stage application keeps only its input and the backward
  recomputes its forward (what ``torch.utils.checkpoint`` does, here done
  by the schedule that owns the backward); without, it keeps its graph.
- :func:`pipeline_value_and_grad` — interleaved 1F1B: ``M + 2(S - 1)``
  ticks, each one forward, the loss head on the last stage, and one
  backward (the stage recomputed from its saved input, then
  ``torch.autograd.grad`` with the gradient seed: ``jax.vjp``), with a
  residual buffer of ``2S - 1`` inputs whatever ``M`` is.

Both skip the *compute* of a fill or drain tick (by linearity it adds
nothing) but never a *hop*: every rank makes the same hops in the same
order.  Bubble fraction (GPipe): ``(S-1)/(M+S-1)``.

**Replicated parameters under ``pp``.**  Every stage receives the last
stage's output (the JAX ``psum`` of the masked ``out``), and every rank
computes the same loss from it, so a parameter used after the trunk (a
head) gets its whole gradient on every stage.  ``x`` is read by stage 0
only, so a parameter that makes ``x`` (an embedding) gets its gradient on
stage 0 only.  Stage 0's gradient of a replicated parameter is therefore
whole — a tied embedding's included — and :class:`PipelineStrategy`
broadcasts it over ``pp``; a sum over ``pp`` would count the head's part
once a stage.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel import sharding as sh
from tensorflowonspark_tpu_torch.parallel.mesh import (MeshSpec, axis_group, group_over,
                                                       make_mesh)
from tensorflowonspark_tpu_torch.parallel.strategy import MeshStrategy, _coalesced
from tensorflowonspark_tpu_torch.util import resolve_device


# ------------------------------------------------------------------ trees

def _leaves(tree, prefix=()):
    """``(path, leaf)`` of a tree of nested dicts, in the dicts' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, k))
    else:
        yield prefix, tree


def _build(paths, values):
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def stack_stage_params(param_list):
    """Stack per-stage parameter trees (identically structured dicts of
    tensors) into one tree whose every leaf gains a leading stage axis of
    size ``len(param_list)``: the axis :func:`pipeline_spec` cuts over
    ``pp``."""
    paths = [p for p, _ in _leaves(param_list[0])]
    return _build(paths, [torch.stack([_get(t, p) for t in param_list]) for p in paths])


def pipeline_spec(tree):
    """Specs cutting every leaf's leading (stage) axis over ``pp``."""
    leaves = list(_leaves(tree))
    return _build([p for p, _ in leaves],
                  [sh.P("pp", *([None] * (leaf.ndim - 1))) for _, leaf in leaves])


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis)) if axis in mesh.mesh_dim_names else 1


def _hop(x, group, offset: int):
    """One tick's hop over the ``pp`` group: send ``x`` to ``offset``
    stages on, receive from ``offset`` stages back (``offset`` -1 carries
    gradients)."""
    return comm.shift(x, group, offset)


def _squeezed(stage_params):
    """Paths and this rank's stage of each leaf (``[1, ...]`` blocks)."""
    paths, leaves = zip(*_leaves(stage_params)) if stage_params else ((), ())
    for path, leaf in zip(paths, leaves):
        if leaf.shape[:1] != (1,):
            raise ValueError(
                f"stage_params leaf {'/'.join(map(str, path))} has shape {tuple(leaf.shape)}: "
                "each pp rank passes its own block of the stacked tree (leading axis 1, "
                "sharding.local_block by pipeline_spec)")
    return list(paths), [leaf[0] for leaf in leaves]


def _data_shards(mesh, data_spec) -> int:
    axes = sh._axes_of(data_spec[0]) if data_spec else sh.DATA_AXES
    return math.prod(_axis_size(mesh, a) for a in axes)


def _check_batch(mesh, x, num_microbatches: int, data_spec, extra: str = "") -> None:
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")
    data_shards = _data_shards(mesh, data_spec)
    batch = x.shape[0] * data_shards
    if batch % (num_microbatches * data_shards):
        raise ValueError(
            f"global batch {batch} must divide by num_microbatches "
            f"({num_microbatches}) x data shards ({data_shards}){extra}")


def _broadcast_from(t: torch.Tensor, group, group_rank: int) -> torch.Tensor:
    """``t`` of group rank ``group_rank`` on every rank of ``group``, in place."""
    if comm.group_size(group) > 1:
        dist.broadcast(t, dist.get_global_rank(group, group_rank), group=group)
    return t


# ------------------------------------------------------------------ GPipe

class _Schedule:
    """What one pipeline call runs: the stage function over this rank's
    parameters, the ``pp`` group and this rank's place in it."""

    def __init__(self, mesh, axis_name, stage_fn, paths, num_microbatches, remat):
        self.group = axis_group(mesh, axis_name)
        self.S = comm.group_size(self.group)
        self.s = mesh.get_local_rank(axis_name)
        self.M = num_microbatches
        self.stage_fn, self.paths, self.remat = stage_fn, paths, remat

    def apply(self, params, inp):
        return self.stage_fn(_build(self.paths, params), inp)

    def forward(self, x, params, keep: bool):
        """The GPipe forward; with ``keep`` and not ``remat`` each
        application's graph is kept for :meth:`backward` (``(input,
        output)``), else its input only (``(input, None)``).  Returns the
        last stage's outputs ``[M, mb, ...]`` on every rank, and what was
        kept."""
        S, s, M = self.S, self.s, self.M
        x_mb = x.reshape((M, x.shape[0] // M) + x.shape[1:])
        zeros = torch.zeros_like(x_mb[0])
        act, out, kept = zeros, torch.zeros_like(x_mb), [None] * M
        for t in range(M + S - 1):
            f = t - s                                  # this stage's microbatch
            y = zeros
            if 0 <= f < M:
                inp = x_mb[f] if s == 0 else act
                if keep and not self.remat:
                    inp = inp.detach().requires_grad_(s > 0 or x.requires_grad)
                    with torch.enable_grad():
                        y = self.apply(params, inp)
                    kept[f] = (inp, y)
                    y = y.detach()
                else:
                    with torch.no_grad():
                        y = self.apply(params, inp)
                    kept[f] = (inp, None)
                if s == S - 1:
                    out[f] = y
            act = _hop(y, self.group, 1)
        return _broadcast_from(out, self.group, S - 1), kept

    def backward(self, g_out, params, kept, x_needs_grad: bool):
        """The reverse schedule: the last stage seeds each microbatch with
        its own output cotangent, every stage backpropagates its kept
        application, and the input gradients hop one stage back a tick."""
        S, s, M = self.S, self.s, self.M
        wrt = [p for p in params if p.requires_grad]
        grads = [torch.zeros_like(p) for p in wrt]
        zeros = torch.zeros_like(g_out[0])
        dx = torch.zeros_like(g_out) if s == 0 and x_needs_grad else None
        recv = zeros
        for t in reversed(range(M + S - 1)):
            f = t - s
            d_inp = zeros
            if 0 <= f < M:
                inp, y = kept[f]
                kept[f] = None
                if y is None:            # remat: the forward again, from its input
                    inp = inp.detach().requires_grad_(s > 0 or x_needs_grad)
                    with torch.enable_grad():
                        y = self.apply(params, inp)
                seed = g_out[f] if s == S - 1 else recv
                inputs = wrt + ([inp] if inp.requires_grad else [])
                res = torch.autograd.grad(y, inputs, seed, allow_unused=True)
                for acc, g in zip(grads, res):
                    if g is not None:
                        acc.add_(g)
                if inp.requires_grad and res[-1] is not None:
                    d_inp = res[-1]
                if dx is not None:
                    dx[f] = d_inp
            recv = _hop(d_inp, self.group, -1)
        it = iter(grads)
        return dx, [next(it) if p.requires_grad else None for p in params]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *params):
        held = [p.detach().requires_grad_(p.requires_grad) for p in params]
        out, kept = sched.forward(x.detach().requires_grad_(x.requires_grad), held, keep=True)
        ctx.sched, ctx.held, ctx.kept, ctx.x_shape = sched, held, kept, x.shape
        ctx.x_grad = x.requires_grad
        return out

    @staticmethod
    def backward(ctx, g_out):
        # every rank computed the same loss from the broadcast output: the
        # last stage's own cotangent is the whole one, counted once
        dx, grads = ctx.sched.backward(g_out.contiguous(), ctx.held, ctx.kept, ctx.x_grad)
        ctx.kept = None
        return None, None if dx is None else dx.reshape(ctx.x_shape), *grads


def pipeline_apply(mesh, stage_fn, stage_params, x, *, num_microbatches: int,
                   axis_name: str = "pp", remat: bool = True, param_specs=None,
                   data_spec=None):
    """Run ``x`` through all pipeline stages; returns the final activations.

    Args:
      mesh: a mesh whose ``axis_name`` size is the stage count ``S``.
      stage_fn: ``(params, x) -> y`` for ONE stage, ``y.shape == x.shape``;
        tensor parallelism inside the stage uses explicit collectives over
        other mesh axes (:func:`~.transformer.make_transformer_stage`).
        Its trainable tensors come in ``params``.
      stage_params: this rank's block of the stacked tree: every leaf
        ``[1, ...]`` (its stage), cut within the stage as ``param_specs``
        says (:func:`~.sharding.local_block` by ``P(axis_name, *spec)``).
      x: this rank's rows of the batch ``[B_local, ...]`` (its block over
        the data axes, or as ``data_spec`` cuts it); every stage of a data
        shard passes the same rows and only stage 0 reads them.  The
        global batch must divide by ``num_microbatches`` x the data shards.
      remat: keep each stage application's input only and recompute its
        forward in the backward (GPipe's per-microbatch checkpointing).
      param_specs, data_spec: the within-stage layout of the blocks, as the
        JAX signature takes it (the caller has cut them; ``data_spec``'s
        batch entry names the data axes).

    Returns ``[B_local, ...]``, the same on every stage of a data shard.
    Differentiable: ``stage_params`` get this stage's gradients; ``x`` its
    gradient on stage 0 (no other stage reads it).  Every stage must
    compute its loss from the output (the backward's hops run on all).
    """
    del param_specs
    _check_batch(mesh, x, num_microbatches, data_spec,
                 "; each dp/fsdp shard pipelines its own microbatches")
    paths, params = _squeezed(stage_params)
    sched = _Schedule(mesh, axis_name, stage_fn, paths, num_microbatches, remat)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        out = _GPipe.apply(sched, x, *params)
    else:
        out, _ = sched.forward(x, params, keep=False)
    return out.reshape(x.shape)


# ------------------------------------------------------------------- 1F1B

def _spec_axes(spec) -> set:
    return {a for entry in spec for a in sh._axes_of(entry)}


def _mean_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.pmean`` of ``t`` over ``axes`` (in place; a no-op over size-1
    axes)."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes and _axis_size(mesh, a) > 1)
    if axes:
        group = group_over(mesh, axes)
        comm.all_reduce(t, group).div_(comm.group_size(group))
    return t


def pipeline_value_and_grad(mesh, stage_fn, head_fn, stage_params, head_params, x, targets,
                            *, num_microbatches: int, axis_name: str = "pp",
                            param_specs=None, data_spec=None, head_specs=None,
                            target_spec=None):
    """Interleaved (1F1B) pipelined train pass: the loss AND the gradients
    in one schedule, with at most ``2S - 1`` saved stage inputs a rank
    however many microbatches run.

    Each of the ``M + 2(S - 1)`` ticks runs on every stage one forward
    microbatch ``f = t - s`` (no graph kept; the input saved in a circular
    buffer of ``2S - 1`` slots, written only for a real microbatch, so a
    drain tick never overwrites a slot whose backward has not run), on the
    last stage the head's loss ``head_fn(head_params, y, target) / M`` and
    its gradient (the seed of microbatch ``f``'s backward, at the same
    tick), one backward microbatch ``b = t - 2(S - 1) + s`` (the stage
    recomputed from its saved input, then ``torch.autograd.grad`` with the
    seed), and a forward and a backward hop.

    Args are :func:`pipeline_apply`'s (blocks and rows of this rank), and:
      head_fn: ``(head_params, y, target) -> scalar``, the per-microbatch
        loss head, run on the last stage.
      head_params: a tree of tensors (replicated, or this rank's blocks as
        ``head_specs`` says).
      targets: this rank's rows of the targets ``[B_local, ...]``.
      param_specs, data_spec, head_specs, target_spec: the blocks' layout
        (default: stage parameters ``P(pp, ...)`` only, rows over the data
        axes, head replicated); they decide the reductions below.

    Returns ``(loss, stage_grads, head_grads, dx)``, reduced as the JAX
    function reduces them: the loss and head gradients from the last
    stage, every output averaged over the data axes and the axes the
    activations are declared cut over (``data_spec``/``target_spec``) but
    not over its own spec's axes; ``stage_grads`` like ``stage_params``
    (``[1, ...]`` blocks), ``head_grads`` like ``head_params``, and ``dx``
    like ``x`` (the gradient entering stage 0, for the embedding's
    backward) from stage 0, divided by the data shards times the declared
    non-data shards.  All four are the same on every stage.
    """
    _check_batch(mesh, x, num_microbatches, data_spec)
    M = num_microbatches
    group = axis_group(mesh, axis_name)
    S, s = comm.group_size(group), mesh.get_local_rank(axis_name)
    last, BUF = S - 1, 2 * S - 1
    paths, params = _squeezed(stage_params)
    params = [p.detach().requires_grad_() for p in params]
    tree = _build(paths, params)
    hpaths, hleaves = zip(*_leaves(head_params)) if head_params else ((), ())
    hleaves = [h.detach().requires_grad_() for h in hleaves]
    htree = _build(hpaths, hleaves)

    mb = x.shape[0] // M
    x_mb = x.detach().reshape((M, mb) + x.shape[1:])
    t_mb = targets.reshape((M, targets.shape[0] // M) + targets.shape[1:])
    zeros = torch.zeros_like(x_mb[0])
    act, grad = zeros, zeros
    buf = [None] * BUF
    dp = [torch.zeros_like(p) for p in params]
    dhp = [torch.zeros_like(h) for h in hleaves]
    dx_out = torch.zeros_like(x_mb)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(M + 2 * (S - 1)):
        f = t - s                                  # forward microbatch
        b = t - 2 * (S - 1) + s                    # backward microbatch
        y, dy, dx_mb = zeros, None, zeros
        if 0 <= f < M:
            inp = x_mb[f] if s == 0 else act
            with torch.no_grad():
                y = stage_fn(tree, inp)
            buf[f % BUF] = inp
            if s == last:
                yh = y.detach().requires_grad_()
                with torch.enable_grad():
                    l_mb = head_fn(htree, yh, t_mb[f]) / M
                res = torch.autograd.grad(l_mb, [yh, *hleaves], allow_unused=True)
                dy = res[0]
                loss += l_mb.detach().float()
                for acc, g in zip(dhp, res[1:]):
                    if g is not None:
                        acc.add_(g)
        if 0 <= b < M:
            x_in = buf[b % BUF].detach().requires_grad_()
            seed = dy if s == last else grad
            with torch.enable_grad():
                y2 = stage_fn(tree, x_in)
            res = torch.autograd.grad(y2, [*params, x_in], seed, allow_unused=True)
            for acc, g in zip(dp, res[:-1]):
                if g is not None:
                    acc.add_(g)
            if res[-1] is not None:
                dx_mb = res[-1]
            if s == 0:
                dx_out[b] = dx_mb
        act = _hop(y, group, 1)
        grad = _hop(dx_mb, group, -1)

    # the loss and head gradients live on the last stage, dx on stage 0
    _broadcast_from(loss, group, last)
    _coalesced(dhp, lambda flat: _broadcast_from(flat, group, last))
    _broadcast_from(dx_out, group, 0)
    x_spec = data_spec if data_spec is not None else sh.P(sh.DATA_AXES)
    t_spec = target_spec if target_spec is not None else sh.P(sh.DATA_AXES)
    mean_axes = (set(sh.DATA_AXES) | _spec_axes(x_spec) | _spec_axes(t_spec)) - {axis_name}
    _mean_over(loss, mesh, mean_axes)
    hspecs = [(_get(head_specs, p) if head_specs is not None else sh.P()) for p in hpaths]
    for g, spec in zip(dhp, hspecs):
        _mean_over(g, mesh, mean_axes - _spec_axes(spec))
    pspecs = ([_get(param_specs, p) for p in paths] if param_specs is not None
              else [sh.P()] * len(paths))
    for g, spec in zip(dp, pspecs):
        _mean_over(g, mesh, mean_axes - _spec_axes(spec))
    dx_div = _data_shards(mesh, None)
    for a in _spec_axes(x_spec):
        if a not in sh.DATA_AXES and a != axis_name and a in mesh.mesh_dim_names:
            dx_div *= _axis_size(mesh, a)
    _mean_over(dx_out, mesh, mean_axes - _spec_axes(x_spec))
    dx = dx_out.reshape(x.shape) / dx_div
    return (loss, _build(paths, [g[None] for g in dp]), _build(hpaths, dhp), dx)


# --------------------------------------------------------------- strategy

class _PipelineRules(sh.PartitionRules):
    """Partition rules: parameters under the top-level ``stages`` module
    cut their leading (stage) axis over ``pp``; everything else
    replicates."""

    def __init__(self):
        super().__init__([])

    def tree_specs(self, params: dict) -> dict:
        return {name: (sh.P("pp", *([None] * (leaf.ndim - 1)))
                       if name.split(".")[0] == "stages" and getattr(leaf, "ndim", 0) >= 1
                       else sh.P())
                for name, _, leaf in sh._named_leaves(params)}


class PipelineStrategy(MeshStrategy):
    """Train a stage-stacked model with GPipe pipelining (+ optional data
    parallelism).

    Usage::

        strat = PipelineStrategy(stage_fn, num_stages=4, num_microbatches=16)
        state = strat.init_state(model, optimizer_fn)   # model.stages: the stacked
        step = strat.build_train_step(loss_fn)          # loss_fn uses strat.apply

    The model's parameters under a top-level ``stages`` module (an
    ``nn.ParameterDict`` or a module tree) carry the leading stage axis:
    :meth:`init_state` keeps each rank's stage (``[1, ...]``); every other
    parameter (embedders, heads) is replicated.  Inside ``loss_fn``, run the
    trunk with ``strat.apply(strat.split(model)[0], x)`` on every stage.
    Gradients: a stage block's are summed over the data axes; a replicated
    parameter's are taken from stage 0 (broadcast over ``pp``; the module
    docstring says why), then summed over the data axes.
    """

    def __init__(self, stage_fn, *, num_stages: int, num_microbatches: int | None = None,
                 devices=None, remat: bool = True, device=None, seed: int = 0, **axis_sizes):
        if "pp" in axis_sizes:
            raise ValueError("pass num_stages=, not pp= (they are the same axis)")
        axis_sizes.setdefault("dp", -1)
        device = resolve_device(device)
        mesh = make_mesh(MeshSpec(**{"pp": num_stages, **axis_sizes}), devices=devices,
                         device_type=device.type)
        super().__init__(mesh=mesh, rules=_PipelineRules(), seed=seed, device=device)
        self.stage_fn = stage_fn
        self.num_stages = num_stages
        self.num_microbatches = (num_microbatches if num_microbatches is not None
                                 else 4 * num_stages)
        self.remat = remat
        self._pp_group = axis_group(mesh, "pp")

    @staticmethod
    def split(model) -> tuple[dict, dict]:
        """``(stages, head)``: the parameters under ``stages`` by their
        names below it, and every other parameter by its name."""
        stages, head = {}, {}
        for name, p in getattr(model, "module", model).named_parameters():
            top, _, rest = name.partition(".")
            if top == "stages":
                stages[rest] = p
            else:
                head[name] = p
        return stages, head

    def apply(self, stage_params, x):
        return pipeline_apply(self.mesh, self.stage_fn, stage_params, x,
                              num_microbatches=self.num_microbatches, remat=self.remat)

    def _reduce_gradients(self, model) -> None:
        # stage 0 holds each replicated parameter's whole gradient
        trained = [p for p in self._replicated if p.requires_grad]
        if trained and comm.group_size(self._pp_group) > 1:
            for p in trained:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _coalesced([p.grad for p in trained],
                       lambda flat: _broadcast_from(flat, self._pp_group, 0))
        super()._reduce_gradients(model)

    def build_train_step_1f1b(self, head_fn, *, param_specs=None, data_spec=None,
                              head_specs=None, target_spec=None):
        """``step(state, (x, targets)) -> (state, {"loss"})`` on the
        interleaved schedule (:func:`pipeline_value_and_grad`).

        The loss is evaluated in the schedule, so it factors as
        ``head_fn(head_params, y, targets)`` on the final activations, with
        ``head_params`` every parameter outside ``stages`` by name.  The
        returned gradients (already averaged over the data axes) update the
        stages and the head through the state's optimizer.  The payoff:
        ``2S - 1`` in-flight residuals instead of ``M + S - 1``."""
        if param_specs is None and any(self.axis_size(a) > 1 for a in ("tp", "sp", "ep")):
            shape = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
            raise ValueError(
                f"the mesh has within-stage axes ({shape}) but no param_specs/data_spec "
                "were given: a stage's collectives would run on replicated parameters and "
                "silently overcount — pass the stage's specs (e.g. make_transformer_stage's "
                "param_specs)")

        def step(state, batch):
            x, targets = batch
            state.optimizer.zero_grad(set_to_none=True)
            stages, head = self.split(state.model)
            loss, d_stages, d_head, _ = pipeline_value_and_grad(
                self.mesh, self.stage_fn, head_fn, stages, head, x, targets,
                num_microbatches=self.num_microbatches, param_specs=param_specs,
                data_spec=data_spec, head_specs=head_specs, target_spec=target_spec)
            for params, grads in ((stages, d_stages), (head, d_head)):
                for name, p in params.items():
                    p.grad = grads[name]
            state.optimizer.step()
            state.step += 1
            return state, {"loss": loss}

        return step

    @property
    def bubble_fraction(self) -> float:
        """GPipe idle fraction: (S-1)/(M+S-1)."""
        s, m = self.num_stages, self.num_microbatches
        return (s - 1) / (m + s - 1)
