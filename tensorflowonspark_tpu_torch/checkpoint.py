"""Checkpointing and model export: the ``model_dir`` / ``export_dir`` contract.

Port of ``tensorflowonspark_tpu/checkpoint.py``.  The reference adds no
checkpoint logic of its own — users pass ``model_dir``/``export_dir`` and
the framework's machinery does the work; the JAX package stands orbax and
``jax.export`` behind that contract.  Here:

- :class:`CheckpointManager` / :func:`save_checkpoint` /
  :func:`restore_checkpoint` — training-state checkpoints through
  ``torch.distributed.checkpoint`` (DCP), with the JAX package's names and
  save semantics (skip, force, ``save_interval_steps``, ``max_to_keep``,
  listeners, async saves), with and without a process group.
- :func:`export_model` / :class:`ExportedModel` — the **SavedModel
  analogue**: a directory holding each serving signature as a
  ``torch.export`` program plus the parameters apart from it.  It is
  loadable *without the Python model code*, carries named **signatures**
  and **tags**, and serves any batch size (dimension 0 of every input is a
  ``torch.export.Dim``).  The parameters are an input of the program, not
  constants in it, and a program is traced on the CPU, so an export
  written by a CPU process serves on the card and the other way round
  (the JAX package's ``platforms=("cpu", "tpu")``).  The flash-attention
  kernels are custom ops (``ops/flash_attention.py``), so a program keeps
  calling them.

Not ported yet (ROADMAP A5): the int8 plainify/requant round trip
(``checkpoint.py:291-395`` in the JAX package), which needs ``ops/quant.py``.

Layout of a ``model_dir``::

    model_dir/<step>/             # one DCP directory a step; its .metadata,
                                  # written last, marks it complete

Layout of an export directory::

    export_dir/
      export_meta.json            # tags, signature specs, format version
      variables/                  # DCP directory: the parameters
      signatures/<name>.pt2       # torch.export program per signature

Checkpoints are written and read by the same PyTorch version; the format
is not promised to cross versions.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from tensorflowonspark_tpu_torch.util import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_SIGNATURE = "serving_default"   # tf.saved_model's default key
DEFAULT_TAGS = ("serve",)               # tf.saved_model.SERVING
_META_NAME = "export_meta.json"
_VARIABLES_DIR = "variables"
_SIGNATURES_DIR = "signatures"
_FORMAT_VERSION = 1
_COMPLETE = ".metadata"                 # DCP writes it after every shard


@contextlib.contextmanager
def _single_process():
    """DCP warns on each call without a process group that it assumes one
    process; here that is the intent (and every restore reads alone)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _group_rank():
    """``(rank, world)`` of the default process group, ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _complete_steps(model_dir: str) -> list[int]:
    """Steps with a complete checkpoint under ``model_dir``, ascending."""
    return sorted(int(name) for name in os.listdir(model_dir)
                  if name.isdigit() and os.path.exists(os.path.join(model_dir, name,
                                                                    _COMPLETE)))


def _host_state(path: str) -> dict:
    """Restore the DCP directory ``path`` with no target: tensors on the
    CPU in their saved dtypes, other values as saved.  The nesting is the
    saved one; dict keys come back as strings."""
    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint._traverse import set_element
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(path).read_metadata()
    target: dict = {}
    for key, item in meta.state_dict_metadata.items():
        value = (torch.empty(item.size, dtype=item.properties.dtype)
                 if isinstance(item, TensorStorageMetadata) else None)
        set_element(target, meta.planner_data[key], value)
    with _single_process():
        dcp.load(target, checkpoint_id=path, no_dist=True)
    return target


# --------------------------------------------------------------------------
# Training checkpoints (DCP behind the reference's model_dir UX)
# --------------------------------------------------------------------------

class CheckpointManager:
    """Periodic training checkpoints under ``model_dir``.

    Equivalent of what reference users get from
    ``tf.keras.callbacks.ModelCheckpoint`` / ``BackupAndRestore`` pointed at
    ``args.model_dir``: keep the last ``max_to_keep`` saves, restore the
    latest on restart.  ``state`` is a nested dict (lists allowed) of
    tensors and plain Python values — e.g. ``{"model": ...,
    "optim": ..., "step": n}`` from
    ``torch.distributed.checkpoint.state_dict.get_state_dict``.

    In a multi-process cluster **every process must call** :meth:`save`
    (DCP coordinates the write, and each replicated tensor is written
    once); gate nothing on ``ctx.is_chief`` here — that gating is only for
    :func:`export_model`.  Under a process group the manager makes a gloo
    group of its own for DCP's collectives (construct it on every process),
    so an async save's collectives never share a group with the training
    step's.  Its semantics are the JAX package's (orbax's): a step at or
    below the last saved one is skipped unless ``force``; otherwise the
    first save and every step divisible by ``save_interval_steps`` are
    written; ``max_to_keep`` drops the oldest saves; ``latest_step`` is
    the last step saved.
    """

    def __init__(self, model_dir: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1, async_save: bool = True):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self._steps = _complete_steps(self.model_dir)   # in save order
        self._pending = None                              # an async save's future
        self._save_listeners: list[Callable[[int, Any], None]] = []
        self._rank, world = _group_rank()
        self._group = None
        if world > 1:
            import torch.distributed as dist

            self._group = dist.new_group(backend="gloo")

    def add_save_listener(self, fn: Callable[[int, Any], None]) -> None:
        """Register ``fn(step, state)`` to run after each save.  Listener
        exceptions are logged and swallowed — publishing must never kill
        training."""
        self._save_listeners.append(fn)

    def _path(self, step: int) -> str:
        return os.path.join(self.model_dir, str(step))

    def _should_save(self, step: int) -> bool:
        if self._steps and self._steps[-1] >= step:
            return False
        return not self._steps or (self.save_interval_steps > 0
                                   and step % self.save_interval_steps == 0)

    def _delete(self, steps: Sequence[int]) -> None:
        """Remove ``steps`` from disk (rank 0; the others wait for it, so
        no process writes into a directory being removed)."""
        if self._rank == 0:
            for step in steps:
                doomed = f"{self._path(step)}.deleting"
                os.replace(self._path(step), doomed)   # gone from listings at once
                shutil.rmtree(doomed)
        if self._group is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` at ``step``; returns True if saved.

        A step that already exists is skipped (a restart may revisit its
        boundary step) — unless ``force=True``, which also bypasses
        ``save_interval_steps`` and REPLACES the existing step.  With
        ``async_save`` the state is copied to host memory before this
        returns and written in the background; :meth:`wait` makes it
        durable."""
        import torch.distributed.checkpoint as dcp

        step = int(step)
        if step in self._steps:
            if not force:
                return False
        elif not force and not self._should_save(step):
            return False
        self.wait()                                   # one save in flight at a time
        if step in self._steps:
            self._steps.remove(step)
            self._delete([step])
        kwargs = {"checkpoint_id": self._path(step), "process_group": self._group,
                  "no_dist": self._group is None}
        with _single_process():
            if self.async_save:
                self._pending = dcp.async_save(state, **kwargs)
            else:
                dcp.save(state, **kwargs)
        self._steps.append(step)
        if self.max_to_keep and len(self._steps) > self.max_to_keep:
            drop = self._steps[:-self.max_to_keep]
            self._steps = self._steps[-self.max_to_keep:]
            self._delete(drop)
        for fn in self._save_listeners:
            try:
                fn(step, state)
            except Exception:
                logger.exception("checkpoint save listener failed (step=%d)", step)
        return True

    def restore(self, step: int | None = None, target=None):
        """Restore the checkpoint at ``step`` (default: latest).

        ``target``: a state of the saved structure whose tensors are loaded
        in place (on whatever device they live) and returned.  Without a
        target, tensors come back on the **CPU**, so a checkpoint written
        on the card restores on a CPU-only driver.  Returns None if no
        checkpoint exists.  Every process reads on its own: no collective.
        """
        import torch.distributed.checkpoint as dcp

        self.wait()
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        if target is None:
            return _host_state(self._path(step))
        with _single_process():
            dcp.load(target, checkpoint_id=self._path(step), no_dist=True)
        return target

    def latest_step(self) -> int | None:
        return self._steps[-1] if self._steps else None

    def all_steps(self) -> Sequence[int]:
        return sorted(self._steps)

    def wait(self) -> None:
        """Block until an async save is durable (call before process exit)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            # a Future, or a response whose upload future is the durable one
            getattr(pending, "upload_completion", pending).result()

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_checkpoint(model_dir: str, state, step: int = 0) -> None:
    """One-shot synchronous checkpoint (convenience over CheckpointManager)."""
    with CheckpointManager(model_dir, async_save=False) as mngr:
        mngr.save(step, state, force=True)


def restore_checkpoint(model_dir: str, target=None, step: int | None = None):
    """Restore the latest (or given-step) checkpoint from ``model_dir``.

    Returns None when the directory does not exist or holds no checkpoint
    — callers use this for the reference's restart-based recovery: try
    restore, else init fresh.
    """
    if not os.path.isdir(model_dir):
        return None
    with CheckpointManager(model_dir, async_save=False) as mngr:
        return mngr.restore(step=step, target=target)


# --------------------------------------------------------------------------
# Model export (the SavedModel analogue)
# --------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """``torch.float32`` → ``"float32"``: numpy's name where numpy has one."""
    return str(dtype).removeprefix("torch.")


def _as_cpu_tensor(x):
    import torch

    return x.detach().cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _program(fn: Callable):
    """``fn(params, *inputs)`` as the module ``torch.export`` traces."""
    import torch

    class Program(torch.nn.Module):
        def forward(self, params, *inputs):
            return fn(params, *inputs)

    return Program()


def export_model(export_dir: str,
                 fn: Callable,
                 params: Mapping[str, Any],
                 example_inputs: Sequence[Any],
                 input_names: Sequence[str] | None = None,
                 output_names: Sequence[str] | None = None,
                 signature_name: str = DEFAULT_SIGNATURE,
                 extra_signatures: Mapping[str, tuple[Callable, Sequence[Any]]] | None = None,
                 tags: Sequence[str] = DEFAULT_TAGS,
                 batch_polymorphic: bool = True,
                 is_chief: bool = True) -> str | None:
    """Write a self-contained serving export of ``fn(params, *inputs)``.

    The reference's ``compat.py::export_saved_model(model, export_dir,
    is_chief)``: only the chief writes (pass ``ctx.is_chief``), everyone
    else returns None.  ``params`` is a state dict (name → tensor, on any
    device); it is written to ``variables/`` and passed to the program as
    its first input.  ``fn`` is traced once per signature with
    ``torch.export`` (non-strict, under ``no_grad``, on the CPU) — e.g.
    ``lambda p, x: torch.func.functional_call(model, p, (x,))``.

    ``batch_polymorphic=True`` exports dimension 0 of every input as one
    ``torch.export.Dim`` so the signature accepts any batch size (the
    SavedModel ``None`` batch dimension; an example batch of 1 is traced
    as 2, since ``torch.export`` specialises a size of 1).
    """
    if not is_chief:
        return None
    import torch
    import torch.distributed.checkpoint as dcp

    export_dir = os.path.abspath(export_dir)
    os.makedirs(os.path.join(export_dir, _SIGNATURES_DIR), exist_ok=True)
    params = {name: _as_cpu_tensor(t) for name, t in params.items()}
    vdir = os.path.join(export_dir, _VARIABLES_DIR)
    shutil.rmtree(vdir, ignore_errors=True)
    with _single_process():
        dcp.save(params, checkpoint_id=vdir, no_dist=True)

    signatures = {signature_name: (fn, example_inputs)}
    signatures.update(extra_signatures or {})
    meta: dict[str, Any] = {"format_version": _FORMAT_VERSION,
                            "tags": sorted(tags), "signatures": {}}
    for name, (sig_fn, sig_inputs) in signatures.items():
        inputs = [_as_cpu_tensor(x) for x in sig_inputs]
        poly = [batch_polymorphic and x.dim() >= 1 for x in inputs]
        traced = [x.repeat(2, *[1] * (x.dim() - 1)) if p and x.shape[0] == 1 else x
                  for x, p in zip(inputs, poly)]
        batch = torch.export.Dim("batch")      # one symbol for every input's batch
        # the program's arguments are (params, inputs): *inputs is one tuple
        dynamic = ({k: None for k in params},
                   tuple({0: batch} if p else None for p in poly))
        with torch.no_grad():
            program = torch.export.export(_program(sig_fn), (params, *traced),
                                          dynamic_shapes=dynamic, strict=False)
        torch.export.save(program, os.path.join(export_dir, _SIGNATURES_DIR, f"{name}.pt2"))

        # input/output names apply to the *main* signature only; extra
        # signatures have their own arity and get positional defaults.
        is_main = name == signature_name
        names_in = (list(input_names) if is_main and input_names
                    else [f"input_{i}" for i in range(len(inputs))])
        output_node = next(n for n in program.graph.nodes if n.op == "output")
        flat_outs = [n.meta["val"] for n in output_node.args[0]]
        names_out = (list(output_names) if is_main and output_names
                     else [f"output_{i}" for i in range(len(flat_outs))])
        if len(names_in) != len(inputs) or len(names_out) != len(flat_outs):
            raise ValueError(
                f"signature '{name}': {len(inputs)} inputs/{len(flat_outs)} outputs "
                f"but {len(names_in)}/{len(names_out)} names given")
        meta["signatures"][name] = {
            "inputs": [
                {"name": n, "dtype": _dtype_name(x.dtype),
                 "shape": ([None] + list(x.shape[1:])) if p else list(x.shape)}
                for n, x, p in zip(names_in, inputs, poly)
            ],
            "outputs": [
                # symbolic dims (the polymorphic batch) serialize as None
                {"name": n, "dtype": _dtype_name(o.dtype),
                 "shape": [d if isinstance(d, int) else None for d in o.shape]}
                for n, o in zip(names_out, flat_outs)
            ],
        }

    with open(os.path.join(export_dir, _META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info("exported model to %s (signatures: %s, tags: %s)",
                export_dir, sorted(signatures), sorted(tags))
    return export_dir


class Signature:
    """One callable serving endpoint of an :class:`ExportedModel`."""

    def __init__(self, name: str, module, params, spec: dict, device):
        self.name = name
        self._module = module
        self._params = params
        self.device = device
        self.input_names = [i["name"] for i in spec["inputs"]]
        self.output_names = [o["name"] for o in spec["outputs"]]
        self.spec = spec

    def __call__(self, *inputs, **named_inputs):
        """Run the signature.  Accepts positional arrays or tensors in
        signature order, or keyword ones by input name; returns a dict of
        tensors on the model's device keyed by output name (the SavedModel
        ``signature(**tensors) -> dict`` shape)."""
        import torch
        from torch.utils import _pytree as pytree

        if named_inputs:
            if inputs:
                raise TypeError("pass inputs positionally or by name, not both")
            inputs = [named_inputs[n] for n in self.input_names]
        args = [(x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(self.device)
                for x in inputs]
        with torch.no_grad():
            outs = self._module(self._params, *args)
        return dict(zip(self.output_names, pytree.tree_leaves(outs)))


class ExportedModel:
    """Loaded export: ``ExportedModel.load(export_dir)`` →
    ``model.signatures['serving_default'](x)``.

    Reference analogue: ``tf.saved_model.load(export_dir, tags)`` as used in
    ``pipeline.py::TFModel._run_model`` (per-executor singleton, signature
    selected by ``signature_def_key``).
    """

    def __init__(self, export_dir: str, params, signatures: dict[str, Signature],
                 tags: Sequence[str]):
        self.export_dir = export_dir
        self.params = params
        self.signatures = signatures
        self.tags = tuple(tags)

    @classmethod
    def load(cls, export_dir: str, tag_set: Sequence[str] | str | None = None,
             device=None) -> "ExportedModel":
        """Load an export onto ``device`` (the card unless ``"cpu"``);
        ``tag_set`` (CSV string or list) must be a subset of the export's
        tags, mirroring SavedModel tag matching."""
        import torch
        from torch.export.passes import move_to_device_pass

        # the programs call the port's custom ops: register them first
        import tensorflowonspark_tpu_torch.ops  # noqa: F401

        device = resolve_device(device)
        export_dir = os.path.abspath(export_dir)
        with open(os.path.join(export_dir, _META_NAME)) as f:
            meta = json.load(f)
        if tag_set:
            want = set(tag_set.split(",") if isinstance(tag_set, str) else tag_set)
            have = set(meta["tags"])
            if not want.issubset(have):
                raise ValueError(f"tag_set {sorted(want)} not found in export "
                                 f"(has {sorted(have)})")

        params = {name: t.to(device) for name, t in
                  _host_state(os.path.join(export_dir, _VARIABLES_DIR)).items()}
        signatures = {}
        for name, spec in meta["signatures"].items():
            program = torch.export.load(
                os.path.join(export_dir, _SIGNATURES_DIR, f"{name}.pt2"))
            if device.type != "cpu":
                # the program was traced on the CPU: its factory calls
                # (e.g. position ids) name that device
                program = move_to_device_pass(program, device)
            signatures[name] = Signature(name, program.module(), params, spec, device)
        return cls(export_dir, params, signatures, meta["tags"])

    def signature(self, key: str = DEFAULT_SIGNATURE) -> Signature:
        if key not in self.signatures:
            raise KeyError(f"signature '{key}' not in export "
                           f"(has {sorted(self.signatures)})")
        return self.signatures[key]

    def __call__(self, *inputs, **named):
        return self.signature()(*inputs, **named)
