"""The serve-step capture cache: each compile site of the batcher as one CUDA graph.

Port of ``tensorflowonspark_tpu/serving/aot.py``.  The JAX package
compiles every serve-step site (``decode``, the ``pfinal``/``pchunk``
prefill buckets, ``verify``, the scatter...) ahead of time and serializes
the executable to disk, so a later process loads instead of compiling.
Eager PyTorch compiles nothing and has no executable to serialize; what a
fixed-shape site costs it is the host: hundreds of kernel launches a call,
each paid in Python.  The counterpart of a compiled site is therefore a
CUDA graph, captured once per site key and replayed on every later call:
one launch from the host, the same kernels on the card.

- A site's FIRST call runs the function eagerly on a side stream (the
  warm-up: its result is the call's result, and the lazy initialisations
  of cuBLAS and the allocator happen outside the capture), then captures
  one ``torch.cuda.CUDAGraph`` over static copies of the arguments.
  Every site of one cache shares one memory pool
  (``torch.cuda.graph_pool_handle()``).
- Each later call copies its tensor arguments into the site's static
  input buffers, replays the graph, and returns fresh copies of the
  static outputs (so no caller ever holds a buffer a later replay
  rewrites).
- ``donate_argnums`` names the arguments a site reads and writes IN
  PLACE — the batcher's KV cache, as the JAX package donates it.  They are
  not copied: the graph is captured over their storage, and every later
  call must pass the very same tensors.  Any other argument is copied.
- A capture counts as a ``compile``.  A capture that fails — or a later
  call whose arguments cannot replay the captured graph (another shape, a
  donated tensor that moved) — counts an ``error`` and runs eagerly; the
  cache never raises mid-stream, as the JAX package's never does.

No disk: a CUDA graph holds raw device pointers and cannot be serialized,
and there is no compile to save, so :attr:`loads` stays 0 and ``dir`` is
kept only for the contract (``stats()``).  What a disk cache could ever
save is a site's first call (warm-up plus capture) over its steady replay;
``bench_serving``'s warm-up scenario measures it.

``capture=`` is the seam the CPU tests drive: a callable ``capture(fn,
args, pool, stream) -> replay`` that records ``fn`` over the static
``args`` WITHOUT running it, and returns a zero-argument ``replay`` that
runs the recorded work over the current contents of ``args`` and returns
its outputs.  The default is the CUDA capture, which needs tensors on a
card: a batcher on the CPU with the default capture raises ``ValueError``
(there is nothing to capture).
"""

from __future__ import annotations

import gc
import logging

import torch
from torch.utils import _pytree as pytree

logger = logging.getLogger(__name__)


def cuda_capture(fn, args, pool, stream):
    """The default capture: ``fn(*args)`` recorded as one CUDA graph in
    ``pool`` on ``stream`` (the one the warm-up ran on).  Recording runs
    no kernel, so the donated state ``args`` point at is untouched until
    the first replay."""
    graph = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture: freeing an earlier
    # batcher's graph or tensors mid-capture would touch the card outside
    # the stream being captured (torch.cuda.graph collects just before)
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        # thread_local: the serve loop's other threads (a weight clone's
        # host copy, the heartbeat) may touch the card while a site captures
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = fn(*args)
    finally:
        if gc_was_on:
            gc.enable()

    def replay():
        graph.replay()
        return outputs
    return replay


class AOTExecutableCache:
    """Capture-or-replay wrapper factory (module docstring).

    ``wrap(site, fn, donate_argnums=..., device=...)`` returns a callable
    with ``fn``'s signature.  Counters: :attr:`compiles` (sites captured),
    :attr:`errors` (failed captures and calls that could not replay, each
    run eagerly), :attr:`loads` (always 0: nothing is read from disk)."""

    def __init__(self, cache_dir: str | None = None, *, capture=None):
        self.cache_dir = None if cache_dir is None else str(cache_dir)
        self.capture = capture
        self.loads = 0
        self.compiles = 0
        self.errors = 0
        self._pool = None
        self._stream = None

    def stats(self) -> dict:
        return {"dir": self.cache_dir, "loads": self.loads,
                "compiles": self.compiles, "errors": self.errors}

    def wrap(self, site, fn, donate_argnums=(), device=None):
        """``fn`` as a captured site.  ``device`` is where its tensors
        live: with the default capture, anything but a card raises
        ``ValueError``."""
        if self.capture is None and device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"AOTExecutableCache captures CUDA graphs; site {site!r} runs on "
                             f"{device}, where there is nothing to capture (pass capture= to "
                             "test the cache off the card)")
        return _GraphSite(self, site, fn, tuple(donate_argnums))

    def pool(self):
        """The memory pool every site of this cache captures into."""
        if self._pool is None and self.capture is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self):
        """The side stream every site warms up and captures on."""
        if self._stream is None and self.capture is None:
            self._stream = torch.cuda.Stream()
        return self._stream


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


class _GraphSite:
    """One call site's capture (see :meth:`AOTExecutableCache.wrap`).
    Shape-monomorphic by contract: the batcher keys its registry per
    shape, so every later call carries the shapes the capture saw."""

    def __init__(self, cache: AOTExecutableCache, site, fn, donate):
        self.cache = cache
        self.site = site
        self.fn = fn
        self.donate = donate
        self._replay = None
        self._eager = False
        self._spec = None       # the captured arguments' tree
        self._leaves = None     # static input leaves (donated ones by reference)
        #: calls of this site, its first included
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        with torch.no_grad():
            if self._eager:
                return self.fn(*args)
            if self._replay is None:
                return self._first_call(args)
            leaves, spec = self._flatten(args)
            if not self._fits(leaves, spec):
                self.cache.errors += 1
                logger.warning("capture site %r: arguments do not match the captured graph; "
                               "running eagerly from now on", self.site)
                self._eager = True
                return self.fn(*args)
            self.refill(leaves)
            return pytree.tree_map(_clone, self._replay())

    def _flatten(self, args):
        """``args`` as leaves, each tagged donated or not."""
        flat, spec = [], []
        for i, a in enumerate(args):
            leaves, s = pytree.tree_flatten(a)
            flat += [(i in self.donate, x) for x in leaves]
            spec.append(s)
        return flat, spec

    def refill(self, leaves) -> None:
        """Copy the call's arguments into the static input buffers."""
        for (donated, new), static in zip(leaves, self._leaves):
            if not donated and torch.is_tensor(new):
                static.copy_(new)

    def _fits(self, leaves, spec) -> bool:
        if spec != self._spec or len(leaves) != len(self._leaves):
            return False
        for (donated, new), static in zip(leaves, self._leaves):
            if torch.is_tensor(new) != torch.is_tensor(static):
                return False
            if not torch.is_tensor(new):
                if new != static:
                    return False
            elif donated:
                if new is not static:
                    return False
            elif new.shape != static.shape or new.dtype != static.dtype \
                    or new.device != static.device:
                return False
        return True

    def _first_call(self, args):
        """Warm up (the call itself, eagerly, on a side stream where
        there is a card), then capture over static copies."""
        cuda = self.cache.capture is None
        side = self.cache.stream()
        if cuda:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                result = self.fn(*args)
            torch.cuda.current_stream().wait_stream(side)
        else:
            result = self.fn(*args)
        leaves, spec = self._flatten(args)
        static = [x if donated else _clone(x) for donated, x in leaves]
        rebuilt, k = [], 0
        for s in spec:
            n = s.num_leaves
            rebuilt.append(pytree.tree_unflatten(static[k:k + n], s))
            k += n
        try:
            capture = self.cache.capture or cuda_capture
            self._replay = capture(self.fn, tuple(rebuilt), self.cache.pool(), side)
        # tfos: ignore[broad-except] — a site that cannot be captured (a host
        # sync, an op CUDA graphs refuse) must keep serving eagerly, counted,
        # never raise mid-stream
        except Exception:
            self.cache.errors += 1
            self._eager = True
            # a capture that failed part-way can leave its pool and stream
            # mid-recording: the next sites capture into fresh ones
            self.cache._pool = self.cache._stream = None
            logger.warning("capture of site %r failed; it runs eagerly", self.site,
                           exc_info=True)
            return result
        self.cache.compiles += 1
        self._spec, self._leaves = spec, static
        return result

