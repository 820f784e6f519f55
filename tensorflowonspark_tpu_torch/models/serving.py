"""Continuous batching for KV-cache decode.

Port of ``tensorflowonspark_tpu/models/serving.py``.  Static batching
wastes the card twice: a new request waits for the whole running batch to
finish, and a finished row keeps its batch slot until the stragglers drain.
Continuous batching treats the decode batch as ``max_batch`` independent
SLOTS over one static-shape KV cache:

- every slot decodes at its own cache offset
  (``GPTConfig.per_row_positions``: each layer's ``index`` and the learned
  ``pos`` counter are ``[B]`` vectors);
- new requests are PREFILLED on a fresh side cache — same-bucket arrivals
  admitted together share ONE batched prefill call — and their cache rows
  and counters are then copied into free slots (running slots never see
  the new prompts);
- a finished slot is released at once and re-admitted on the next step.

The model mutates its cache in place (``model(ids, cache=cache)``), so
every step function returns only the tokens it picked, and the cache is
the batcher's own from construction to the end.  What the JAX package
compiles once per shape is a plain callable here, kept in the same
registry under the same keys (``_prefill_jit``): one decode step for the
lifetime, one prefill per (power-of-two prompt BUCKET, power-of-two
admission GROUP), one chunk step, one K-step decode block per power of
two taken.  The shapes stay static (prompts right-padded, groups padded
to a power of two, side caches kept one per group size), so with
``aot_cache=`` (``serving/aot.py``) each site is captured once as a CUDA
graph and replayed.  A pad row's prefill never lands: the host knows the
slot list and copies only the real rows (the JAX package drops an
out-of-bounds scatter).

With ``kv_page_tokens`` the cache goes PAGED: per-layer K/V pools behind
per-row block tables (``models/gpt.py``), host-side page accounting with a
refcounted shared-prefix index (``models/kv_pages.py``), admission tied to
free PAGES, and prefix-hit requests prefilling only their tails.

Output contract: a request's tokens are a pure function of its own
(params, prompt, budget, temperature, top_p, seed) — never of admission
order, slot reuse or batch company.  ``temperature=0`` (the default) is
greedy: the tokens of a solo ``greedy_generate`` run on that prompt.
``temperature>0`` samples the nucleus ``top_p`` (``nucleus_filter``,
shared with ``sample_generate``) with Gumbel noise drawn from a counter
hash of (seed, n, vocab index) for the request's n-th token, on the
device: no generator state, no host round trip.  JAX's threefry stream
(``fold_in(key(seed), n)``) cannot be reproduced in PyTorch, so sampled
tokens differ from the JAX package's while keeping its contract.

Over tensor-parallel shards (``tp=``, a ``models.gpt.TensorParallel``) every
rank of the group runs its own batcher over its shards, and the ranks are
driven by the same calls in the same order (``serving/sharded.py``'s
step descriptor).  The host decides admission, buckets, pages, the prefix
cache, speculation and sampling from values that are equal on every rank
(the logits are gathered whole), so the decisions are too; only the model
calls carry collectives.  Over gloo the batcher runs eagerly: a CUDA graph
cannot capture a gloo collective.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models import gpt as _gpt
from tensorflowonspark_tpu_torch.models.gpt import (GPTConfig, init_cache, nucleus_filter,
                                                    rewind_cache)
from tensorflowonspark_tpu_torch.models.kv_pages import KVPagePool, hash_page_data
from tensorflowonspark_tpu_torch.ops.quant import _QuantArray


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclass
class _Slot:
    request_id: int
    remaining: int
    tokens: list = field(default_factory=list)  # generated so far
    temperature: float = 0.0                    # 0 = greedy
    top_p: float = 1.0
    seed: int = 0
    lease: object = None                        # paged mode: PageLease


# ----------------------------------------------------------- token selection

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, exact: the
    constant is split in 16-bit halves so no product leaves int64."""
    return (x * (c & 0xFFFF) + ((x * (c >> 16)) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    """A 32-bit avalanche (lowbias32) over int64 tensors in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel(seeds, steps, vocab: int):
    """Gumbel noise ``[B, vocab]`` as a pure function of each row's (seed,
    step) and the vocab index: a counter hash, the same bits on any device."""
    row = _mix32(_mix32(seeds.long() & _M32) ^ (steps.long() & _M32))           # [B]
    col = _mix32((torch.arange(vocab, device=seeds.device) + 0x9E3779B9) & _M32)
    h = _mix32(row[:, None] ^ col[None, :])
    u = ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))                            # (0, 1)
    return -torch.log(-torch.log(u))


def _select_tokens(logits, seeds, steps, temps, top_ps):
    """Per-row next token: argmax at temperature 0, else a nucleus (top-p)
    sample at the row's temperature.  A row's draw depends only on its own
    (seed, step) — ``step`` is the request's count of generated tokens —
    and its logits, never on batch company, slot or admission order."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    noisy = nucleus_filter(scaled, top_ps[:, None]) + _gumbel(seeds, steps, logits.shape[-1])
    return torch.where(temps <= 0, greedy, torch.argmax(noisy, dim=-1))


def _decode_one_greedy(model, cache, tokens):
    """THE greedy decode step: the per-step callable and the decode blocks
    both call it, so a block's tokens cannot drift from single steps'."""
    return torch.argmax(model(tokens[:, None], cache=cache)[:, -1], dim=-1)


def _decode_one_sampled(model, cache, tokens, seeds, steps, temps, top_ps):
    """THE sampled decode step (see :func:`_decode_one_greedy`)."""
    return _select_tokens(model(tokens[:, None], cache=cache)[:, -1], seeds, steps, temps,
                          top_ps)


def _copy_rows(cache: dict, rows: dict, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy rows ``src`` of the side cache ``rows`` into rows ``dst`` of
    ``cache``, every leaf."""
    for name, leaf in cache.items():
        if name != "layers":
            leaf.index_copy_(0, dst, rows[name].index_select(0, src))
    for lc, rc in zip(cache["layers"], rows["layers"]):
        for name, leaf in lc.items():
            leaf.index_copy_(0, dst, rc[name].index_select(0, src))


def _zero_cache(cache: dict) -> dict:
    """``cache`` back to :func:`init_cache`'s state, in place (a dense
    cache: every leaf starts at zero)."""
    for leaf in _leaves(cache):
        leaf.zero_()
    return cache


def _copy_cache(dst: dict, src: dict) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _leaves(cache: dict) -> list:
    out = [leaf for name, leaf in cache.items() if name != "layers"]
    return out + [leaf for lc in cache["layers"] for leaf in lc.values()]


def _counters(cache: dict) -> list:
    """Every position counter of a cache: each layer's ``index`` and the
    learned-position ``pos``."""
    out = [lc["index"] for lc in cache["layers"]]
    if "pos" in cache:
        out.append(cache["pos"])
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy; bf16, which numpy lacks, as its raw int16."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _host_dtype(dtype: torch.dtype) -> str:
    return "int16" if dtype == torch.bfloat16 else str(torch.empty((), dtype=dtype).numpy().dtype)


def _device_array(a, dtype: torch.dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.view(dtype) if dtype == torch.bfloat16 else t


def _storage(params: dict) -> list[torch.Tensor]:
    """Every tensor a state dict holds, a quantized leaf's ``q`` and
    ``scale`` included, in name order."""
    out = []
    for n in sorted(params):
        v = params[n]
        out += [v.q, v.scale] if isinstance(v, _QuantArray) else [v]
    return out


def _copy_leaf(v):
    if isinstance(v, _QuantArray):
        return v._replace(v.q.clone(), v.scale.clone())
    return v.detach().clone()


def _meta_leaf(v):
    """A leaf's shape and dtype without its storage."""
    if isinstance(v, _QuantArray):
        return v._replace(v.q.to("meta"), v.scale.to("meta"))
    return v.detach().to("meta")


def _as_device_leaf(v, like, device):
    """One incoming ``load_params`` leaf on ``device``: a quantized leaf
    with its tensors moved, anything else as a tensor — int16 bits where
    the built leaf ``like`` is bf16 are read back as bf16."""
    if isinstance(v, _QuantArray):
        return v._replace(torch.as_tensor(v.q).to(device), torch.as_tensor(v.scale).to(device))
    t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
    if like is not None and getattr(like, "dtype", None) == torch.bfloat16 \
            and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def host_params(params: dict) -> dict:
    """A state dict as host arrays to cross a process boundary: tensors as
    numpy (bf16 as its int16 bits, which ``load_params`` reads back),
    quantized leaves with their tensors on the CPU."""
    return {n: v._replace(v.q.cpu(), v.scale.cpu()) if isinstance(v, _QuantArray)
            else _host(v) for n, v in params.items()}


def merge_session_shards(session: dict, kvs: list) -> dict:
    """The whole session of a tensor-parallel prefill: ``session`` is the
    one the leader's batcher exported (its own heads), ``kvs`` every rank's
    K/V leaves of it in rank order; the heads are joined (axis 2 of each
    ``[pages, page_tokens, heads, head_dim]`` leaf) and the page hashes and
    struct recomputed, so the result is what a single-process prefill of
    the same weights exports."""
    kv = [np.concatenate([np.asarray(k[i]) for k in kvs], axis=2)
          for i in range(len(session["kv"]))]
    n = int(session["pages"])
    return {**session, "kv": kv, "page_hashes": hash_page_data(kv, n),
            "struct": [(tuple(a.shape[1:]), str(a.dtype)) for a in kv]}


# --------------------------------------------------------------- draft model

class DraftModel:
    """Draft provider for draft-model speculative decoding (Leviathan et
    al.): a SMALL model whose forward proposes up to k greedy tokens per
    decode row, which the target's verify call then accepts or rejects
    (``ContinuousBatcher.set_draft``).

    Cache-less by design: the draft re-runs a full forward over each row's
    trailing ``window`` tokens k times in ONE call instead of mirroring the
    target's paged admission machinery.  Correctness never depends on the
    draft: a proposal is committed only where the target's own argmax
    agrees, so an untrained or wrong draft costs acceptance, never
    exactness.  ``window + k`` must fit the draft's
    ``max_position_embeddings`` (checked at ``set_draft``).  The draft
    runs on its state dict's device; under ``tp`` over its shards, in the
    target batcher's group.
    """

    def __init__(self, cfg: GPTConfig, params, window: int = 64, tp=None):
        if window < 1:
            raise ValueError(f"draft window must be >= 1, got {window}")
        self.cfg = cfg
        self.params = params
        self.window = int(window)
        self.tp = tp
        self.model = _gpt._model(cfg, params, tp)    # full forward — no decode cache
        self.device = _gpt._device_of(params)
        self.dispatches = 0
        self._aot = None               # set by ContinuousBatcher.set_draft
        #: the propose callable per (rows, buffer length, k)
        self._propose: dict = {}

    def _propose_jit(self, B: int, L: int, k: int):
        key = ("propose", B, L, k)
        if key not in self._propose:
            fn = functools.partial(self._propose_fn, k)
            self._propose[key] = fn if self._aot is None else \
                self._aot.wrap(key, fn, device=self.device)
        return self._propose[key]

    @torch.no_grad()
    def propose(self, buf: np.ndarray, lens: np.ndarray, k: int) -> np.ndarray:
        """k greedy draft tokens per row: ``buf [B, window + k]`` holds each
        row's right-zero-padded trailing history, ``lens [B]`` its true
        length (>= 1).  One call for the whole batch; rows the caller deems
        ineligible have their proposals ignored (the verify mask decides)."""
        self.dispatches += 1
        buf = torch.from_numpy(np.asarray(buf)).to(self.device, torch.long)
        lens = torch.from_numpy(np.asarray(lens)).to(self.device, torch.long)
        return self._propose_jit(*buf.shape, int(k))(buf, lens).cpu().numpy()   # [B, k]

    def _propose_fn(self, k: int, buf, lens):
        rows = torch.arange(buf.shape[0], device=buf.device)
        table = self.model._table().float()
        out = []
        for _ in range(k):
            h = self.model.hidden(buf)[rows, lens - 1]                 # [B, H]
            nxt = torch.argmax(self.model.gather_vocab(h.float() @ table.T), dim=-1)
            buf[rows, lens] = nxt                    # lens <= window + k - 1 < L
            lens = lens + 1
            out.append(nxt)
        return torch.stack(out, dim=1)


# ------------------------------------------------------------------- batcher

class ContinuousBatcher:
    """Admit/step/retire decode requests over one batch — greedy by
    default, per-request nucleus sampling via ``submit``'s
    ``temperature``/``top_p``/``seed`` (deterministic per request,
    independent of batch company).  Runs on the device of ``params`` (a
    ``GPT`` state dict: tensors, or ``ops.quant`` arrays).

    ``aot_cache`` (a :class:`~tensorflowonspark_tpu_torch.serving.aot.
    AOTExecutableCache`) captures each call site of the registry — the
    decode step, the prefill buckets, chunks, scatters, verify and decode
    blocks — as one CUDA graph at its first call and replays it after
    (:meth:`aot_stats`); the tokens are the eager batcher's.  A graph
    reads the storage it was captured over, so a batcher with an
    ``aot_cache`` keeps its own copy of the weights (one more model's
    worth of device memory); without one it reads the caller's tensors.

    ``tp`` (a ``models.gpt.TensorParallel``): ``params`` are this rank's
    Megatron shards (``parallel.sharding.gpt_partition_rules``, quantized
    ones through ``ops.shard_quantized``), and every rank of the group
    drives its own batcher with the same calls (module docstring).  A gloo
    group takes no ``aot_cache``.

    Usage::

        b = ContinuousBatcher(cfg, params, max_batch=8, eos_id=50256)
        for prompt, n in requests: b.submit(prompt, n)
        results = b.run()          # {request_id: np.ndarray tokens}

    or drive it by hand: ``submit`` while ``b.has_free_slot()`` (queued
    requests count against the free slots), ``step()`` once per decode
    step (returns every request id finished since the last call, those
    finished at admission included), submit more as slots free up.
    """

    def __init__(self, cfg: GPTConfig, params, max_batch: int,
                 eos_id: int | None = None,
                 prefill_chunk: int | None = None,
                 speculative_k: int | None = None,
                 speculative_ngram: int = 3,
                 speculative_window: int = 2048,
                 decode_block_steps: int | None = None,
                 kv_page_tokens: int | None = None,
                 kv_pool_pages: int | None = None,
                 prefix_cache: bool = True,
                 prefill_only: bool = False,
                 aot_cache=None, tp=None):
        if aot_cache is not None and tp is not None \
                and torch.distributed.get_backend(tp.group) == "gloo":
            raise ValueError(
                "aot_cache over a gloo tp group: a CUDA graph cannot capture a gloo "
                "collective (gloo stages through the host), so a tp batcher over gloo "
                "runs eagerly — drop aot_cache")
        if cfg.rolling_kv_cache:
            raise ValueError("ContinuousBatcher requires a full-length "
                             "cache (rolling_kv_cache=False)")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if speculative_k is not None and speculative_k < 1:
            raise ValueError(f"speculative_k must be >= 1, got {speculative_k}")
        if speculative_ngram < 1:
            raise ValueError(f"speculative_ngram must be >= 1, got {speculative_ngram}")
        if speculative_window < speculative_ngram + 1:
            raise ValueError(f"speculative_window must be > speculative_ngram, "
                             f"got {speculative_window}")
        if decode_block_steps is not None and decode_block_steps < 2:
            raise ValueError(f"decode_block_steps must be >= 2, got {decode_block_steps}")
        if decode_block_steps is not None and speculative_k is not None:
            # drafting is host-side control flow per step; a block of steps
            # cannot host it — the two amortizations are alternatives
            raise ValueError(
                "decode_block_steps and speculative_k are mutually exclusive (a "
                "decode block cannot host the per-step draft/verify control flow) "
                "— for multi-token decode calls keep speculative_k and arm a draft "
                "model (set_draft) instead of blocking")
        if prefill_only:
            if kv_page_tokens is None:
                raise ValueError("prefill_only needs kv_page_tokens: the KV-page "
                                 "handoff a prefill pool emits is page-granular")
            if speculative_k is not None or decode_block_steps is not None:
                raise ValueError("prefill_only is a prefill-pool posture; "
                                 "speculative_k/decode_block_steps are decode-time knobs")
        #: multi-step decode: when no admission work is pending, run up to
        #: this many decode steps in ONE call (power-of-two block sizes);
        #: the tokens are the single steps' — only host round trips differ
        self.decode_block_steps = decode_block_steps
        #: prompt-lookup speculative decoding INSIDE continuous batching:
        #: every decode step drafts up to ``speculative_k`` tokens per
        #: greedy slot from its own history and one verify call over k+1
        #: positions commits each slot's OWN accepted length
        self.spec_k = speculative_k
        self.spec_ngram = speculative_ngram
        #: drafting scans only the trailing ``speculative_window`` tokens
        #: of a request's history: O(window) host work a step
        self.spec_window = speculative_window
        #: speculation accounting: draft tokens proposed / accepted
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: draft-MODEL speculation (:meth:`set_draft`); None = prompt lookup
        self._draft_model = None
        #: draft-model propose calls (each covers every eligible row)
        self.draft_dispatches = 0
        #: accepted draft length per drafted row per verify call, drained
        #: by :meth:`take_spec_accept_lens`
        self._accept_lens: list[int] = []
        #: long-context admission: prompts longer than this prefill in
        #: fixed chunks through the cached path, one chunk per ``step()``
        self.prefill_chunk = prefill_chunk
        if kv_page_tokens is not None:
            pt = int(kv_page_tokens)
            per_req = -(-cfg.max_position_embeddings // pt)
            # default pool: dense-equivalent capacity (every slot can hold a
            # max-length request); smaller pools are legal, and ``submit``
            # rejects any single request the whole pool cannot hold
            pool_pages = int(kv_pool_pages) if kv_pool_pages is not None \
                else int(max_batch) * per_req
            # GPTConfig validates (power of two, divisibility, int8 conflicts)
            self.cfg = dataclasses.replace(cfg, per_row_positions=True, kv_page_tokens=pt,
                                           kv_pool_pages=pool_pages)
            self._pages = KVPagePool(pool_pages, pt, prefix_cache=bool(prefix_cache))
        else:
            if kv_pool_pages is not None:
                raise ValueError("kv_pool_pages needs kv_page_tokens")
            self._pages = None
            self.cfg = dataclasses.replace(cfg, per_row_positions=True)
        if aot_cache is not None:
            #: with captured sites, the batcher's own copy of the weights:
            #: the storage its graphs read, which ``load_params`` overwrites
            #: and ``unload_params`` zeroes.  Without, the caller's tensors
            params = {n: _copy_leaf(v) for n, v in params.items()}
        self.params = params
        #: names, shapes and dtypes of the state dict the callables were
        #: built over; ``load_params`` holds every later one to it
        self._params_struct = self._struct_of(params)
        self.device = _gpt._device_of(params)
        self.max_batch = int(max_batch)
        self.eos_id = eos_id
        #: the tensor-parallel group (None: the whole model in this process)
        self.tp = tp
        self.model = _gpt._model(self.cfg, params, tp)
        self.cache = init_cache(self.cfg, params, self.max_batch, tp)
        self.slots: list[_Slot | None] = [None] * self.max_batch
        #: PREFILL-ONLY mode (a disaggregated prefill pool): admission and
        #: prefill as usual, but a seated request never decode-steps; its
        #: session (prompt KV pages, first token, sampler state) is exported
        #: for :meth:`take_sessions` and its pages release at once
        self.prefill_only = bool(prefill_only)
        self._sessions: list[tuple[int, dict]] = []
        #: (request_id, session) adoptions awaiting a slot and pages
        self._pending_adopt: list[tuple[int, dict]] = []
        #: lifetime handoff counters (exported here / adopted here)
        self.sessions_exported = 0
        self.sessions_adopted = 0
        #: lifetime call counters: ``prefill_dispatches`` (a batched group
        #: admission counts once; chunk calls excluded), ``decode_dispatches``
        #: (one per decode call with active slots — a block counts once)
        #: and ``decode_steps`` (a block counts its K steps)
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps = 0
        #: the original error once a device step has raised mid-flight: the
        #: cache is written in place, so after a failed step the slots and
        #: the cache can no longer be trusted, and the batcher refuses use
        self._poisoned: str | None = None
        # (rid, prompt, budget, temperature, top_p, seed)
        self._pending: list[tuple[int, np.ndarray, int, float, float, int]] = []
        #: the at-most-one chunked admission in flight (one chunk a step);
        #: its target slot is reserved until the final chunk lands
        self._inflight: dict | None = None
        self._reserved: set[int] = set()
        self._ids = itertools.count()
        self._results: dict[int, np.ndarray] = {}
        #: per-request streaming callbacks (``submit(on_token=...)``)
        self._on_token: dict[int, object] = {}
        #: prompt per live request (drafting and session export read it)
        self._prompts: dict[int, np.ndarray] = {}
        #: the call registry, keyed as the JAX package's compile sites that
        #: capture: ("final", pow2_bucket, pow2_rows), ("chunk", C),
        #: ("scatter", rows), ("pfinal", bucket, rows), ("pchunk", C),
        #: "verify", ("block", K, sampled)
        self._prefill_jit: dict = {}
        #: how many times each site's callable was registered (each exactly once)
        self._built: dict = {}
        #: the capture cache (``serving/aot.py``), or None: plain calls
        self._aot = aot_cache
        #: the prefill side caches, one per admission-group size, zeroed in
        #: place for each group: a captured site reads and writes the same
        #: storage on every call.  A chunked admission streams into its own
        #: (``_chunk_cache``) and is copied into the 1-row one for its final
        self._side: dict[int, dict] = {}
        self._chunk_cache: dict | None = None
        # two callables so all-greedy traffic never pays the sampler
        self._step = self._jit(("step",), functools.partial(_decode_one_greedy, self.model),
                               donate_argnums=(0,))
        self._step_sample = self._jit(("step_sample",),
                                      functools.partial(_decode_one_sampled, self.model),
                                      donate_argnums=(0,))

    def _jit(self, site, fn, donate_argnums=()):
        """THE call-site chokepoint (the JAX package's compile sites): every
        device callable is registered here once per key, and counted; with
        an ``aot_cache`` it is the site's capture.  ``donate_argnums``: the
        arguments the site writes in place (the caches), passed as the same
        tensors on every call."""
        self._built[site] = self._built.get(site, 0) + 1
        if self._aot is None:
            return fn
        return self._aot.wrap(site, fn, donate_argnums=donate_argnums, device=self.device)

    def aot_stats(self) -> dict | None:
        """The capture cache's ``{dir, loads, compiles, errors}``, or None
        when the batcher runs without one."""
        return None if self._aot is None else self._aot.stats()

    def _site(self, key, fn, donate_argnums=()):
        """The callable registered under ``key`` (``fn``, at its first use)."""
        if key not in self._prefill_jit:
            self._prefill_jit[key] = self._jit(key, fn, donate_argnums)
        return self._prefill_jit[key]

    def _tensor(self, values, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(self.device)

    def _scatter_rows(self, row_cache, slot_idx: list[int]) -> None:
        """Copy a prefilled side cache's rows into the batch slots named by
        ``slot_idx`` — one indexed copy a leaf however many rows were
        admitted.  Pad rows (a group padded to a power of two) carry slot
        ``max_batch``: the host leaves them out, so their prefill never
        lands; the index lists keep the group's length by repeating the
        first real pair (the same row copied twice)."""
        real = [(j, s) for j, s in enumerate(slot_idx) if 0 <= s < self.max_batch]
        if real:
            real += real[:1] * (len(slot_idx) - len(real))
            self._site(("scatter", len(slot_idx)), _copy_rows, donate_argnums=(0, 1))(
                self.cache, row_cache, self._tensor([j for j, _ in real]),
                self._tensor([s for _, s in real]))

    def _check_usable(self) -> None:
        if self._poisoned is not None:
            raise RuntimeError(
                "ContinuousBatcher is unusable: a device step failed while it was "
                "writing the KV cache in place, so in-flight requests and the cache "
                "are unrecoverable. Build a new batcher and resubmit. Original "
                f"error: {self._poisoned}")
        if self.params is None:
            raise RuntimeError(
                "ContinuousBatcher has no parameters loaded (unload_params() — "
                "warm-standby mode); call load_params() before submitting")

    # -- warm-standby parameter swap --------------------------------------
    def unload_params(self) -> None:
        """Drop the weights while KEEPING every built callable and the cache
        (the warm-standby posture).  Without an ``aot_cache`` the model
        lets go of them (it keeps their names, shapes and dtypes only);
        with one, their storage stays — the captured sites read it — and
        is zeroed, and :meth:`load_params` copies the next weights into
        it.  Refuses while any request is live; ``submit`` raises until
        :meth:`load_params` re-arms it."""
        self._check_idle("unload params")
        if self.params is not None:
            if self._aot is None:
                _gpt.bind(self.model, {n: _meta_leaf(v)
                                       for n, v in self._bound_params().items()})
            else:
                with torch.no_grad():
                    for t in _storage(self.params):
                        t.zero_()
        self.params = None

    def _check_idle(self, what: str) -> None:
        if self.load()["total"] or self._reserved:
            raise RuntimeError(f"cannot {what} with live requests (load={self.load()})")

    @staticmethod
    def _struct_of(params) -> tuple:
        """``(names, [(shape, dtype)])`` of a state dict — what the
        callables and the cache were built over."""
        names = tuple(sorted(params))
        return (names, [(tuple(getattr(params[n], "shape", ())),
                         str(getattr(params[n], "dtype", "?"))) for n in names])

    def load_params(self, params) -> None:
        """(Re)arm the batcher with a state dict of the SAME names, shapes
        and dtypes (a cloned, restored or hot-swapped version; numpy arrays
        are moved to the batcher's device, bf16 leaves may come as their
        int16 bits).  Anything else raises ``ValueError`` before a weight
        changes.  With an ``aot_cache`` the values are COPIED into the
        storage the batcher was built over, so every captured site sees
        them; without, the model is bound to them.  The paged pool's
        PREFIX INDEX is rebuilt empty: cached pages hold K/V of the OLD
        weights.  Refuses while a request is live."""
        if params is None:
            raise ValueError("load_params needs a parameter tree")
        self._check_idle("load params")
        bound = self._bound_params()
        params = {n: _as_device_leaf(v, bound.get(n), self.device) for n, v in params.items()}
        names, leaves = self._struct_of(params)
        want_names, want_leaves = self._params_struct
        if names != want_names:
            raise ValueError(
                "load_params: parameter names differ from the ones this batcher was "
                "built over (another architecture/version?) — rebuild the batcher instead")
        bad = [i for i, (got, want) in enumerate(zip(leaves, want_leaves)) if got != want]
        if bad:
            raise ValueError(
                f"load_params: {len(bad)} leaf(s) differ in shape/dtype from the built "
                f"tree (first: {names[bad[0]]} got {leaves[bad[0]]}, want "
                f"{want_leaves[bad[0]]}) — an incompatible model version cannot reuse "
                "this batcher")
        pairs = [(_storage({n: bound[n]}), _storage({n: params[n]})) for n in names]
        if any([t.shape for t in a] != [t.shape for t in b] for a, b in pairs):
            raise ValueError("load_params: a quantized leaf's storage differs in shape from "
                             "the built tree — an incompatible model version cannot reuse "
                             "this batcher")
        if self._pages is not None:
            # idle (checked above): a fresh host-side pool of the same
            # geometry drops the stale index (idle rows are parked; the
            # device block tables are rewritten at each admission)
            self._pages = KVPagePool(self._pages.total_pages, self._pages.page_tokens,
                                     prefix_cache=self._pages.prefix_cache)
        if self._aot is None:
            _gpt.bind(self.model, params)
            self.params = params
            return
        with torch.no_grad():
            for dst, src in pairs:
                for d, s in zip(dst, src):
                    d.copy_(s)
        self.params = bound

    def _bound_params(self) -> dict:
        """The state dict the model reads: the storage every site uses."""
        return {f"{owner}.{attr}" if owner else attr: value
                for owner, module in self.model.named_modules()
                for attr, value in module._parameters.items()}

    def set_role(self, role: str | None) -> None:
        """Specialize an idle batcher for a disaggregated pool role:
        ``"prefill"`` turns :attr:`prefill_only` on under the constructor's
        constraints (paged KV, no decode-time knobs); ``"decode"``/``None``
        turns it off.  Only legal while no request is live."""
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"unknown role {role!r} (want 'prefill', 'decode' or None)")
        if self.load()["total"] or self._reserved:
            raise RuntimeError(f"cannot set_role({role!r}) with live requests "
                               f"(load={self.load()})")
        if role == "prefill":
            if self._pages is None:
                raise ValueError("prefill role needs paged KV (kv_page_tokens): the "
                                 "KV-page handoff a prefill pool emits is page-granular")
            if self.spec_k is not None or self.decode_block_steps is not None:
                raise ValueError("prefill role conflicts with speculative_k/"
                                 "decode_block_steps (decode-time knobs)")
        self.prefill_only = role == "prefill"

    # -- draft-model speculation ------------------------------------------
    def set_draft(self, draft: "DraftModel | None") -> None:
        """Arm (or clear, with ``None``) a :class:`DraftModel` as the
        speculation proposer: eligible greedy rows get their k draft tokens
        from ONE draft call instead of the host-side prompt lookup, and the
        verify commits the agreeing prefix.  Sampled rows keep the draft-0
        fallback.  Misconfiguration is rejected here, typed."""
        if draft is None:
            self._draft_model = None
            return
        if not isinstance(draft, DraftModel):
            raise TypeError(f"set_draft wants a DraftModel, got {type(draft).__name__}")
        if self.prefill_only:
            raise ValueError("draft_model conflicts with prefill_only: a prefill pool "
                             "never decodes, so it has no speculation to accelerate")
        if self.spec_k is None:
            raise ValueError("draft_model needs speculative_k: the draft proposes into "
                             "the k-token verify window (pass speculative_k= to the batcher)")
        if draft.cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft/target vocab mismatch: draft vocab_size={draft.cfg.vocab_size} vs "
                f"target {self.cfg.vocab_size} — draft proposals index the target's token "
                "space, so the tokenizers must be identical")
        if getattr(draft.tp, "group", None) is not getattr(self.tp, "group", None):
            raise ValueError(
                "draft and target run over different tp groups: a tp batcher's draft "
                "proposes over its shards in the target's group (DraftModel(..., tp=))")
        if draft.window + self.spec_k > draft.cfg.max_position_embeddings:
            raise ValueError(
                f"draft window {draft.window} + speculative_k {self.spec_k} exceeds the "
                f"draft's max_position_embeddings ({draft.cfg.max_position_embeddings}) "
                "— shrink the window or use a longer-context draft")
        if self._aot is not None and draft._aot is None:
            # the draft's propose sites capture into the target's cache
            # (one pool, one set of counters)
            draft._aot = self._aot
        self._draft_model = draft

    def take_spec_accept_lens(self) -> list[int]:
        """Drain the per-row accepted draft lengths recorded by verify calls
        since the last drain (host ints, one per drafted row per call)."""
        out, self._accept_lens = self._accept_lens, []
        return out

    def _emit_token(self, rid: int, tok: int) -> None:
        cb = self._on_token.get(rid)
        if cb is not None:
            cb(rid, tok)

    def load(self) -> dict:
        """Queue depth for routers: ``active`` decoding slots, ``pending``
        queued requests (the in-flight chunked admission and queued
        adoptions included), ``reserved`` slots, ``total`` = active +
        pending — every live request counted once; in paged mode
        ``free_pages`` (free + evictable cached) and ``total_pages``, else
        0 and 0."""
        active = sum(s is not None for s in self.slots)
        pending = len(self._pending) + len(self._pending_adopt) \
            + (1 if self._inflight is not None else 0)
        pages = self._pages
        return {"active": active, "pending": pending, "reserved": len(self._reserved),
                "total": active + pending,
                "free_pages": 0 if pages is None else pages.free_pages(),
                "total_pages": 0 if pages is None else pages.total_pages}

    def prefix_stats(self) -> dict:
        """Prefix-cache admission outcomes (zeros for a dense batcher):
        ``hit``, ``partial``, ``miss``, ``evictions`` and the page gauges."""
        if self._pages is None:
            return {"hit": 0, "miss": 0, "partial": 0, "evictions": 0,
                    "free_pages": 0, "cached_pages": 0, "total_pages": 0}
        return self._pages.stats()

    # -- KV-page session handoff: a prefill-only batcher EXPORTS each
    # admitted request — its prompt K/V pages (host numpy, hashed per page),
    # first token and sampler state — and a decode batcher ADOPTS it into a
    # slot without re-running a prompt token.
    def _pool_leaves(self) -> list[torch.Tensor]:
        """The K/V pool leaves in cache order (layer by layer, K then V)."""
        return [lc[n] for lc in self.cache["layers"] for n in ("k", "v")]

    def _kv_struct(self, whole: bool = False) -> list:
        """Per-page layout of the pool leaves: ``((page_tokens, heads,
        head_dim), host dtype)`` per K/V leaf, exported with every transfer
        and compared on import.  Over ``tp`` a leaf holds this rank's heads;
        ``whole`` gives the layout of every rank's heads side by side (a
        session's, which crosses pools unsharded)."""
        pt, parts = self.cfg.kv_page_tokens, 1 if self.tp is None or not whole else self.tp.size
        return [((pt, leaf.shape[1] * parts) + tuple(leaf.shape[2:]), _host_dtype(leaf.dtype))
                for leaf in self._pool_leaves()]

    def _pool_view(self, leaf: torch.Tensor) -> torch.Tensor:
        """``[pages, page_tokens, heads, head_dim]`` over a pool leaf (its
        scratch row left out)."""
        P, pt = self.cfg.kv_pool_pages, self.cfg.kv_page_tokens
        return leaf[:P * pt].view(P, pt, *leaf.shape[1:])

    @torch.no_grad()
    def _gather_pages(self, page_ids: list[int]) -> list[np.ndarray]:
        """Host numpy copies ``[n, page_tokens, heads, head_dim]`` of the
        pool pages ``page_ids`` from every K/V leaf (a read: the cache is
        not touched)."""
        n = len(page_ids)
        if n == 0:
            return []
        ids = self._tensor(page_ids)
        return [_host(self._pool_view(leaf).index_select(0, ids)) for leaf in self._pool_leaves()]

    @torch.no_grad()
    def _seat_pages_device(self, slot: int, row_pages: list[int], import_ids: list[int],
                           kv_sel: list[np.ndarray], counter: int) -> None:
        """Write imported page data into the K/V pools at ``import_ids``
        and seat ``slot``'s block-table row (``row_pages``) and counters
        (``counter``).  ``slot == max_batch`` seats nothing (a pure page
        import: the prefix-cache clone)."""
        P = self.cfg.kv_pool_pages
        npg = self.cfg.max_position_embeddings // self.cfg.kv_page_tokens
        row_bt = np.full((npg,), P, np.int64)
        row_bt[:len(row_pages)] = row_pages
        if import_ids:
            ids = self._tensor(list(import_ids))
            for leaf, blk in zip(self._pool_leaves(), kv_sel):
                self._pool_view(leaf).index_copy_(0, ids,
                                                  _device_array(blk, leaf.dtype, leaf.device))
        if slot < self.max_batch:
            row_bt = self._tensor(row_bt)
            for lc in self.cache["layers"]:
                lc["block_table"][slot] = row_bt
            for c in _counters(self.cache):
                c[slot] = int(counter)

    def _export_session(self, s: _Slot) -> dict:
        """The handoff descriptor of one just-prefilled request: prompt,
        first token, sampler state and every page of its prompt K/V (shared
        prefix pages included), each page content-hashed."""
        pt = self.cfg.kv_page_tokens
        prompt = self._prompts[s.request_id]
        n_pp = -(-prompt.size // pt)
        kv = self._gather_pages(s.lease.page_ids[:n_pp])
        return {"v": 1, "prompt": np.asarray(prompt, np.int32),
                "tokens": [int(t) for t in s.tokens], "remaining": int(s.remaining),
                "temperature": float(s.temperature), "top_p": float(s.top_p),
                "seed": int(s.seed), "page_tokens": int(pt), "pages": int(n_pp),
                "kv": kv, "page_hashes": hash_page_data(kv, n_pp),
                "struct": self._kv_struct()}

    def take_sessions(self) -> list[tuple[int, dict]]:
        """Drain the exported sessions (prefill-only mode): ``(request_id,
        session)`` pairs since the last call; a taken request's stored
        result is dropped (its completion belongs to the adopting pool)."""
        out, self._sessions = self._sessions, []
        for rid, _ in out:
            self._results.pop(rid, None)
        return out

    def adopt_session(self, session: dict, on_token=None) -> int:
        """Queue a handed-off session for adoption, verified here — layout
        AND per-page content hashes, so a corrupt or raced transfer raises
        ``ValueError`` without touching the device — and seated on the next
        ``step()`` with a free slot and pages.  The seated request decodes
        from its first token on without re-prefilling.  Over ``tp`` the
        session is the whole one (every head, as a single-process prefill
        exports it, or a prefill gang's leader gathers it): it is verified
        whole, and this rank keeps its own heads.  Returns the local
        request id."""
        self._check_usable()
        if self._pages is None:
            raise ValueError("adopt_session needs paged KV mode (kv_page_tokens)")
        if self.prefill_only:
            raise ValueError("a prefill-only batcher cannot adopt sessions "
                             "(it never decode-steps)")
        if not isinstance(session, dict) or session.get("v") != 1:
            raise ValueError("malformed session descriptor")
        missing = [k for k in ("prompt", "tokens", "remaining", "page_tokens", "pages", "kv",
                               "page_hashes", "struct") if k not in session]
        if missing:
            raise ValueError(f"malformed session descriptor: missing key(s) {missing}")
        pt = self._pages.page_tokens
        if int(session["page_tokens"]) != pt:
            raise ValueError(f"session page_tokens {session['page_tokens']} != this pool's "
                             f"{pt} — prefill and decode pools must agree")
        prompt = np.asarray(session["prompt"], np.int32).reshape(-1)
        tokens = [int(t) for t in session["tokens"]]
        remaining = int(session["remaining"])
        if prompt.size == 0 or len(tokens) != 1 or remaining < 1:
            raise ValueError("a handoff session carries exactly the first token and a "
                             f"positive remaining budget (got {len(tokens)} token(s), "
                             f"remaining {remaining})")
        n_pp = -(-prompt.size // pt)
        kv = session["kv"]
        struct = self._kv_struct(whole=True)
        ok_shape = int(session.get("pages", -1)) == n_pp and len(kv) == len(struct)
        if ok_shape:
            for a, (shape, dt) in zip(kv, struct):
                a = np.asarray(a)
                if a.ndim != 4 or a.shape[0] != n_pp or tuple(a.shape[1:]) != shape \
                        or str(a.dtype) != dt:
                    ok_shape = False
                    break
        if not ok_shape:
            raise ValueError("session KV layout mismatch — the transfer raced a replica "
                             "with a different model/cache geometry; rejecting the session")
        got = hash_page_data(kv, n_pp)
        want = list(session["page_hashes"])
        if got != want:
            bad = [j for j, (g, w) in enumerate(zip(got, want)) if g != w]
            raise ValueError(f"corrupt KV-page transfer: content hash mismatch on page(s) "
                             f"{bad} of {n_pp} — rejecting the session")
        if self.tp is not None:
            heads = self._pool_leaves()[0].shape[1]
            kv = [np.asarray(a)[:, :, self.tp.rank * heads:(self.tp.rank + 1) * heads]
                  for a in kv]
        total = prompt.size + len(tokens) + remaining
        if total > self.cfg.max_position_embeddings:
            raise ValueError(f"session needs {total} positions, exceeding "
                             f"max_position_embeddings ({self.cfg.max_position_embeddings})")
        if self._pages.pages_needed(total) > self._pages.total_pages:
            raise ValueError(f"session needs {self._pages.pages_needed(total)} KV pages but "
                             f"the pool holds {self._pages.total_pages}")
        rid = next(self._ids)
        self._pending_adopt.append(
            (rid, {**session, "prompt": prompt, "tokens": tokens, "remaining": remaining,
                   "kv": kv}))
        if on_token is not None:
            self._on_token[rid] = on_token
        if self.spec_k is not None:
            self._prompts[rid] = prompt[-self.spec_window:]
        return rid

    def _admit_adopts(self) -> None:
        """Seat queued adoptions: lease pages (prefix-index matches need no
        import), import the unmatched prompt pages, seat the block-table
        row and counters, and activate the slot mid-stream (its first token
        was emitted by the prefill side).  Strict FIFO on pages."""
        while self._pending_adopt:
            free = [i for i, s in enumerate(self.slots)
                    if s is None and i not in self._reserved]
            if not free:
                return
            rid, sess = self._pending_adopt[0]
            prompt = sess["prompt"]
            total = prompt.size + len(sess["tokens"]) + sess["remaining"]
            lease = self._pages.adopt(prompt, total)
            if lease is None:
                return          # pages free as running requests finish
            self._pending_adopt.pop(0)
            n_pp = -(-prompt.size // self._pages.page_tokens)
            import_ids = lease.page_ids[lease.n_shared:n_pp]
            kv_sel = []
            if import_ids:
                kv_sel = [np.asarray(a)[lease.n_shared:n_pp] for a in sess["kv"]]
            # counters seat at prompt.size: the next decode step feeds the
            # first token and writes its K/V there, as a local prefill would
            self._seat_pages_device(free[0], lease.page_ids, import_ids, kv_sel, prompt.size)
            # commit AFTER the import: only written pages are matchable
            self._pages.commit(lease)
            self.sessions_adopted += 1
            self.slots[free[0]] = _Slot(
                request_id=rid, remaining=int(sess["remaining"]), tokens=list(sess["tokens"]),
                temperature=float(sess.get("temperature", 0.0)),
                top_p=float(sess.get("top_p", 1.0)), seed=int(sess.get("seed", 0)),
                lease=lease)

    # -- prefix-cache cloning (warm-standby promotion)
    def export_prefix_cache(self, max_pages: int | None = None) -> dict | None:
        """Snapshot the SHARED prefix-cache pages (every indexed page, in
        insertion order, content-hashed) for a peer to import; None when
        dense or empty."""
        if self._pages is None:
            return None
        entries = self._pages.export_index()
        if max_pages is not None:
            entries = entries[:max_pages]
        if not entries:
            return None
        pids = [pid for _, pid in entries]
        kv = self._gather_pages(pids)
        return {"v": 1, "keys": [k for k, _ in entries], "pages": len(pids), "kv": kv,
                "page_hashes": hash_page_data(kv, len(pids)),
                "page_tokens": int(self._pages.page_tokens), "struct": self._kv_struct()}

    def import_prefix_cache(self, export: dict | None) -> int:
        """Adopt a peer's cloned prefix-cache pages into this pool as
        refcount-0 cached pages, matchable by the next admission.  Layout
        and per-page hashes are verified first.  Returns the pages
        imported."""
        if self._pages is None or not export:
            return 0
        if int(export.get("page_tokens", -1)) != self._pages.page_tokens \
                or [(tuple(s), d) for s, d in export.get("struct", [])] != self._kv_struct():
            raise ValueError("prefix-cache transfer layout mismatch — donor and importer "
                             "cache geometries differ")
        n = int(export["pages"])
        kv = export["kv"]
        if hash_page_data(kv, n) != list(export["page_hashes"]):
            raise ValueError("corrupt prefix-cache transfer: content hash mismatch — "
                             "rejecting the import")
        mapping = self._pages.adopt_cached(export["keys"])
        if not mapping:
            return 0
        pos_of = {k: i for i, k in enumerate(export["keys"])}
        keys = list(mapping)
        sel = [pos_of[k] for k in keys]
        kv_sel = [np.asarray(a)[sel] for a in kv]
        # slot = max_batch: only the pages are written
        self._seat_pages_device(self.max_batch, [], [mapping[k] for k in keys], kv_sel, 0)
        return len(mapping)

    # -- admission ---------------------------------------------------------
    def has_free_slot(self) -> bool:
        """True while another ``submit`` would find a slot: queued requests
        (and the slot reserved for a chunked admission) count against the
        free slots, so ``while b.has_free_slot(): b.submit(...)`` ends."""
        free = sum(s is None and i not in self._reserved for i, s in enumerate(self.slots))
        return len(self._pending) + len(self._pending_adopt) < free

    def submit(self, prompt_ids, max_new_tokens: int, *, temperature: float = 0.0,
               top_p: float = 1.0, seed: int = 0, on_token=None) -> int:
        """Queue a request; it is admitted on the next ``step()`` with a
        free slot.  Returns the request id.

        ``temperature=0`` decodes greedily — the tokens of a solo
        ``greedy_generate``.  ``temperature>0`` samples the nucleus
        ``top_p`` keyed by ``seed``: a pure function of (params, prompt,
        budget, temperature, top_p, seed).  ``on_token(request_id, token)``
        streams every COMMITTED token in order from inside the ``step()``
        that commits it (tokens a block or verify computes past eos or the
        budget never surface); it runs on the driving thread, and an
        exception from it poisons the batcher like a device failure."""
        self._check_usable()
        if torch.is_tensor(prompt_ids):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens} "
                             "(the greedy-exact contract has no 0-token decode)")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if not -2**31 <= seed < 2**31:
            raise ValueError(f"seed must fit int32, got {seed}")
        total = prompt.size + max_new_tokens
        if total > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) = {total} "
                f"exceeds max_position_embeddings ({self.cfg.max_position_embeddings})")
        if self._pages is not None \
                and self._pages.pages_needed(total) > self._pages.total_pages:
            # a request the WHOLE pool cannot hold would wait at the head of
            # the queue forever
            raise ValueError(
                f"request needs {self._pages.pages_needed(total)} KV pages ({total} tokens "
                f"at {self._pages.page_tokens}/page) but the pool holds "
                f"{self._pages.total_pages}")
        rid = next(self._ids)
        self._pending.append((rid, prompt, int(max_new_tokens), float(temperature),
                              float(top_p), int(seed)))
        if on_token is not None:
            self._on_token[rid] = on_token
        if self.spec_k is not None:        # drafting reads the trailing window
            self._prompts[rid] = prompt[-self.spec_window:]
        elif self.prefill_only:            # session export needs the whole prompt
            self._prompts[rid] = prompt
        return rid

    def _fresh_rows_cache(self, rows: int) -> dict:
        """The ``rows``-row side cache, zeroed in place (allocated at its
        first use)."""
        if rows not in self._side:
            self._side[rows] = self._zeros(rows)
        return _zero_cache(self._side[rows])

    def _zeros(self, rows: int) -> dict:
        # init_cache reads only the device off its parameters
        return init_cache(self.cfg, {"device": torch.empty(0, device=self.device)}, rows,
                          self.tp)

    def _fresh_chunk_cache(self) -> dict:
        """The chunked admission's own 1-row cache, zeroed in place."""
        if self._chunk_cache is None:
            self._chunk_cache = self._zeros(1)
        return _zero_cache(self._chunk_cache)

    def _chunk_jit(self):
        return self._site(("chunk", self.prefill_chunk), self._chunk_fn, donate_argnums=(0,))

    def _chunk_fn(self, cache: dict, tokens_row: torch.Tensor) -> None:
        self.model.hidden(tokens_row, cache=cache)       # K/V only: no LM head

    def _advance_inflight(self) -> list[int]:
        """Advance the in-flight chunked admission by ONE chunk, or finish
        it: the bucketed final call on the remainder and the copy into the
        reserved slot.  Running slots decode meanwhile."""
        inf = self._inflight
        C = self.prefill_chunk
        rid, prompt, budget, temp, top_p, seed = inf["req"]
        n_full = (prompt.size - 1) // C   # >= 1 token left for the final
        i = inf["done_chunks"]
        if i < n_full:
            self._chunk_jit()(inf["cache"], self._tensor(prompt[None, i * C:(i + 1) * C]))
            inf["done_chunks"] += 1
            return []
        # the final call runs over the 1-row group cache (the sites' own
        # storage): the streamed chunks are copied into it first
        row_cache = self._fresh_rows_cache(1)
        _copy_cache(row_cache, inf["cache"])
        first = self._prefill_final(
            row_cache, [prompt[n_full * C:]], [prompt.size], [temp], [top_p], [seed])
        slot = inf["slot"]
        self._reserved.discard(slot)
        self._scatter_rows(row_cache, [slot])
        self._inflight = None
        tok = int(first.cpu()[0])
        self._emit_token(rid, tok)
        s = _Slot(request_id=rid, remaining=budget - 1, tokens=[tok], temperature=temp,
                  top_p=top_p, seed=seed)
        if s.remaining <= 0 or tok == self.eos_id:
            self._finish(slot, s)
            return [rid]
        self.slots[slot] = s
        return []

    def _prefill_final(self, cache, rests: list, true_totals: list, temps: list,
                       top_ps: list, seeds: list):
        """THE bucketed prefill call — a whole-prompt admission GROUP
        (fresh ``len(rests)``-row side cache, padded to a power of two) and
        the last chunk of a chunked prefill (1-row cache) both end here.
        Prefills ``cache`` in place and returns the first tokens on the
        device; entries past ``len(rests)`` are padding.

        Why the right-padding is exact: prefill attention is causal, so pad
        tokens never reach a true last position's logits (taken per row at
        ``true_len - 1``); each row's counters are then REWOUND to its true
        total, after which the positional mask hides every pad slot until
        the decode loop overwrites it with a real token's K/V in the same
        forward that first makes it visible; and pad ROWS never reach the
        batch (:meth:`_scatter_rows`)."""
        R = len(rests)
        rp = cache["layers"][0]["index"].shape[0]           # cache rows (pow2)
        Tp = min(_next_pow2(max(r.size for r in rests)), self.cfg.max_position_embeddings)
        padded = np.zeros((rp, Tp), np.int64)
        true_len = np.ones((rp,), np.int64)
        for j, r in enumerate(rests):
            padded[j, :r.size] = r
            true_len[j] = r.size
        tot = np.ones((rp,), np.int64)
        tot[:R] = true_totals
        seed_a = np.zeros((rp,), np.int64)
        seed_a[:R] = seeds
        temp_a = np.zeros((rp,), np.float32)
        temp_a[:R] = temps
        top_a = np.ones((rp,), np.float32)
        top_a[:R] = top_ps
        self.prefill_dispatches += 1
        return self._site(("final", Tp, rp), self._final_fn, donate_argnums=(0,))(
            cache, self._tensor(padded), self._tensor(true_len), self._tensor(tot),
            self._tensor(seed_a), self._tensor(temp_a, torch.float32),
            self._tensor(top_a, torch.float32))

    def _final_fn(self, cache, tokens, true_len, true_tot, seeds, temps, top_ps):
        logits = self.model(tokens, cache=cache)
        last = logits[torch.arange(tokens.shape[0], device=tokens.device), true_len - 1]
        first = _select_tokens(last, seeds, torch.zeros_like(true_len), temps, top_ps)
        rewind_cache(cache, true_tot)
        return first

    def _admit(self) -> list[int]:
        """Fill free slots from the pending queue; returns the ids of
        requests that finished AT admission (1-token budget or immediate
        eos).  Requests taken in one round are grouped by power-of-two
        prompt bucket and each group shares ONE prefill call and one row
        copy.  Prompts beyond ``prefill_chunk`` stream through the
        at-most-one in-flight chunked admission, one chunk a step.  The
        loop repeats while finished-at-admission requests free slots."""
        if self._pages is not None:
            return self._admit_paged()
        done = []
        if self._inflight is not None:
            done.extend(self._advance_inflight())
        while self._pending:
            free = [i for i, s in enumerate(self.slots)
                    if s is None and i not in self._reserved]
            if not free:
                break
            C = self.prefill_chunk
            taken_idx = []
            whole = []
            for j, req in enumerate(self._pending):
                if len(free) - len(whole) == 0:  # every free slot claimed
                    break
                if C is not None and req[1].size > C:
                    if self._inflight is not None:
                        # one chunked admission at a time; SKIP (don't stall
                        # the queue): shorts behind it still admit
                        continue
                    slot = free.pop()        # reserve from the tail
                    self._reserved.add(slot)
                    self._inflight = {"req": req, "slot": slot,
                                      "cache": self._fresh_chunk_cache(), "done_chunks": 0}
                    taken_idx.append(j)
                    # first slice: a chunked prompt has >= 1 full chunk before
                    # the final call, so it cannot finish on this slice
                    self._advance_inflight()
                else:
                    taken_idx.append(j)
                    whole.append(req)
            if not taken_idx:
                break
            for j in reversed(taken_idx):
                del self._pending[j]
            groups: dict[int, list] = {}
            for req in whole:
                Tp = min(_next_pow2(req[1].size), self.cfg.max_position_embeddings)
                groups.setdefault(Tp, []).append(req)
            free_iter = iter(free)
            seated = []   # (slots, reqs, first tokens on the device)
            for reqs in groups.values():
                rp = _next_pow2(len(reqs))
                rows = self._fresh_rows_cache(rp)
                firsts = self._prefill_final(
                    rows, [r[1] for r in reqs],
                    [r[1].size for r in reqs], [r[3] for r in reqs], [r[4] for r in reqs],
                    [r[5] for r in reqs])
                slots = [next(free_iter) for _ in reqs]
                # pad rows target slot max_batch: never copied
                self._scatter_rows(rows, slots + [self.max_batch] * (rp - len(reqs)))
                seated.append((slots, reqs, firsts[:len(reqs)]))
            if not seated:
                continue
            # one host read for the round's first tokens
            firsts = torch.cat([f for _, _, f in seated]).cpu().numpy()
            k = 0
            for slots, reqs, _ in seated:
                for slot, (rid, _, budget, temp, top_p, seed) in zip(slots, reqs):
                    tok = int(firsts[k])
                    k += 1
                    self._emit_token(rid, tok)
                    s = _Slot(request_id=rid, remaining=budget - 1, tokens=[tok],
                              temperature=temp, top_p=top_p, seed=seed)
                    if s.remaining <= 0 or tok == self.eos_id:
                        self._finish(slot, s)   # slot stays free; loop refills
                        done.append(rid)
                    else:
                        self.slots[slot] = s
        return done

    # -- paged admission ---------------------------------------------------
    def _admit_paged(self) -> list[int]:
        """Paged admission (see :meth:`_admit`): each taken request first
        LEASES pages — a prefix-index match plus fresh tail pages — and a
        request the pool cannot serve right now blocks the queue (strict
        FIFO: pages free as running requests finish; ``submit`` rejected
        requests larger than the pool).  Groups key on the power-of-two
        TAIL bucket after the prefix match."""
        done: list[int] = []
        self._admit_adopts()   # handed-off sessions seat before new prompts
        if self._inflight is not None:
            done.extend(self._advance_inflight_paged())
        C = self.prefill_chunk
        while self._pending:
            free = [i for i, s in enumerate(self.slots)
                    if s is None and i not in self._reserved]
            if not free:
                break
            taken_idx: list[int] = []
            whole = []                           # (req, lease)
            blocked = False
            for j, req in enumerate(self._pending):
                if len(free) - len(whole) == 0:  # every free slot claimed
                    break
                prompt, budget = req[1], req[2]
                # the cheap size test first: the hash-chain peek runs only for
                # prompts that could need chunking
                if C is not None and self._inflight is not None and prompt.size > C \
                        and prompt.size - self._pages.match_tokens(prompt) > C:
                    # one chunked admission at a time; SKIP before leasing (a
                    # trial lease could evict cached prefix pages)
                    continue
                lease = self._pages.admit(prompt, prompt.size + budget)
                if lease is None:
                    blocked = True
                    break
                if C is not None and prompt.size - lease.tail_start > C:
                    if self._inflight is not None:
                        self._pages.release(lease)
                        continue
                    slot = free.pop()            # reserve from the tail
                    self._reserved.add(slot)
                    self._inflight = {"req": req, "slot": slot, "lease": lease,
                                      "done_chunks": 0}
                    taken_idx.append(j)
                    self._advance_inflight_paged()   # first slice: no token yet
                else:
                    taken_idx.append(j)
                    whole.append((req, lease))
            if not taken_idx:
                break
            for j in reversed(taken_idx):
                del self._pending[j]
            groups: dict[int, list] = {}
            for req, lease in whole:
                Tp = min(_next_pow2(req[1].size - lease.tail_start),
                         self.cfg.max_position_embeddings)
                groups.setdefault(Tp, []).append((req, lease))
            free_iter = iter(free)
            admitted = []   # (slot, req-fields, first_token, lease)
            for reqs in groups.values():
                slots = [next(free_iter) for _ in reqs]
                firsts = self._prefill_paged([(req, lease, lease.tail_start)
                                              for req, lease in reqs], slots)
                for j, (req, lease) in enumerate(reqs):
                    rid, _, budget, temp, top_p, seed = req
                    admitted.append((slots[j], (rid, budget, temp, top_p, seed),
                                     int(firsts[j]), lease))
            for slot, (rid, budget, temp, top_p, seed), tok, lease in admitted:
                self._emit_token(rid, tok)
                s = _Slot(request_id=rid, remaining=budget - 1, tokens=[tok],
                          temperature=temp, top_p=top_p, seed=seed, lease=lease)
                if s.remaining <= 0 or tok == self.eos_id:
                    self._finish(slot, s)   # slot stays free; loop refills
                    done.append(rid)
                else:
                    self.slots[slot] = s
            if blocked:
                break
        return done

    def _row_cache(self, row_bt: torch.Tensor, start: torch.Tensor) -> dict:
        """A cache over the shared pools with its own block tables and
        counters: the pools are written in place through it, the batch's
        tables and counters are untouched."""
        layers = [{"index": start.clone(), "block_table": row_bt, "k": lc["k"], "v": lc["v"]}
                  for lc in self.cache["layers"]]
        out = {"layers": layers}
        if "pos" in self.cache:
            out["pos"] = start.clone()
        return out

    def _prefill_paged(self, entries, slots: list[int]) -> np.ndarray:
        """THE paged prefill, one call per admission group: (1) prefill each
        row's TAIL (after its prefix-cache match) straight into its leased
        pages through a per-row block-table view of the shared pool — shared
        prefix pages are only READ; (2) take each row's first token at its
        true last prompt position; (3) seat the rows' block tables and
        counters (at their true totals) in the batch cache.

        ``entries`` = ``[(req_tuple, lease, start)]``, ``start`` the first
        prompt position fed here.  Pad rows carry all-sentinel block tables
        (their writes go to the scratch row) and are never seated.  Commits
        every lease after the call, so only computed pages are matchable."""
        cfgC = self.cfg.max_position_embeddings
        P = self.cfg.kv_pool_pages
        npg = cfgC // self.cfg.kv_page_tokens
        Tp = min(_next_pow2(max(req[1].size - start for req, _, start in entries)), cfgC)
        R, rp = len(entries), _next_pow2(len(entries))
        row_bt = np.full((rp, npg), P, np.int64)
        row_start = np.zeros((rp,), np.int64)
        tokens = np.zeros((rp, Tp), np.int64)
        true_len = np.ones((rp,), np.int64)
        true_tot = np.ones((rp,), np.int64)
        seed_a = np.zeros((rp,), np.int64)
        temp_a = np.zeros((rp,), np.float32)
        top_a = np.ones((rp,), np.float32)
        for j, (req, lease, start) in enumerate(entries):
            _, prompt, _, temp, top_p, seed = req
            tail = prompt[start:]
            row_bt[j, :len(lease.page_ids)] = lease.page_ids
            row_start[j] = start
            tokens[j, :tail.size] = tail
            true_len[j] = tail.size
            true_tot[j] = prompt.size
            seed_a[j] = seed
            temp_a[j] = temp
            top_a[j] = top_p
        self.prefill_dispatches += 1
        firsts = self._site(("pfinal", Tp, rp), self._pfinal_fn)(
            self._tensor(tokens), self._tensor(row_bt), self._tensor(row_start),
            self._tensor(true_len), self._tensor(true_tot), self._tensor(slots[:R]),
            self._tensor(seed_a), self._tensor(temp_a, torch.float32),
            self._tensor(top_a, torch.float32))
        for _, lease, _ in entries:
            self._pages.commit(lease)
        return firsts.cpu().numpy()

    def _pfinal_fn(self, tokens, row_bt, row_start, true_len, true_tot, slot_ids, seeds,
                   temps, top_ps):
        logits = self.model(tokens, cache=self._row_cache(row_bt, row_start))
        last = logits[torch.arange(tokens.shape[0], device=tokens.device), true_len - 1]
        first = _select_tokens(last, seeds, torch.zeros_like(true_len), temps, top_ps)
        n = slot_ids.shape[0]                    # the real rows
        for lc in self.cache["layers"]:
            lc["block_table"].index_copy_(0, slot_ids, row_bt[:n])
        for c in _counters(self.cache):
            c.index_copy_(0, slot_ids, true_tot[:n])
        return first

    def _pchunk_jit(self):
        """One fixed-chunk paged prefill: streams a chunk of the in-flight
        admission's tail into its leased pages (the batch's tables and
        counters untouched: the slot goes live at the final call)."""
        return self._site(("pchunk", self.prefill_chunk), self._pchunk_fn)

    def _pchunk_fn(self, tokens_row, row_bt, start) -> None:
        self.model.hidden(tokens_row, cache=self._row_cache(row_bt, start))

    def _advance_inflight_paged(self) -> list[int]:
        """Paged edition of :meth:`_advance_inflight`: chunks stream the
        prompt tail straight into the leased pages, the bucketed final call
        goes through :meth:`_prefill_paged`."""
        inf = self._inflight
        C = self.prefill_chunk
        req = inf["req"]
        rid, prompt, budget, temp, top_p, seed = req
        lease = inf["lease"]
        n_full = (prompt.size - lease.tail_start - 1) // C
        i = inf["done_chunks"]
        if i < n_full:
            start = lease.tail_start + i * C
            npg = self.cfg.max_position_embeddings // self.cfg.kv_page_tokens
            row_bt = np.full((1, npg), self.cfg.kv_pool_pages, np.int64)
            row_bt[0, :len(lease.page_ids)] = lease.page_ids
            self._pchunk_jit()(self._tensor(prompt[None, start:start + C]),
                               self._tensor(row_bt), self._tensor([start]))
            inf["done_chunks"] += 1
            return []
        slot = inf["slot"]
        self._reserved.discard(slot)
        firsts = self._prefill_paged([(req, lease, lease.tail_start + n_full * C)], [slot])
        self._inflight = None
        tok = int(firsts[0])
        self._emit_token(rid, tok)
        s = _Slot(request_id=rid, remaining=budget - 1, tokens=[tok], temperature=temp,
                  top_p=top_p, seed=seed, lease=lease)
        if s.remaining <= 0 or tok == self.eos_id:
            self._finish(slot, s)
            return [rid]
        self.slots[slot] = s
        return []

    def _park_slot(self, i: int) -> None:
        """Paged mode: a finished slot's pages go back to the pool, but the
        batch step still runs every row — park the row's counters at
        max_len so its writes go to the scratch row instead of pages now
        owned by someone else (the block-table row is replaced at the
        slot's next admission)."""
        for c in _counters(self.cache):
            c[i] = self.cfg.max_position_embeddings

    def _finish(self, i: int, s: _Slot) -> None:
        self._results[s.request_id] = np.asarray(s.tokens, np.int32)
        self._prompts.pop(s.request_id, None)
        self._on_token.pop(s.request_id, None)
        self.slots[i] = None
        if self._pages is not None:
            if s.lease is not None:
                self._pages.release(s.lease)
                s.lease = None
            self._park_slot(i)

    # -- decode ------------------------------------------------------------
    def step(self) -> list[int]:
        """Admit pending requests into free slots, run ONE decode step for
        every active slot, and return every request id that finished —
        during decode or at admission.

        If a device call raises (OOM, a lost card), the batcher is marked
        unusable — the cache is written in place, so the instance cannot
        be resumed — and every later call raises ``RuntimeError`` naming
        the original failure."""
        self._check_usable()
        try:
            with torch.no_grad():
                return self._step_inner()
        except Exception as e:
            self._poisoned = f"{type(e).__name__}: {e}"
            raise

    def _history(self, s: "_Slot", prompt: np.ndarray, W: int) -> np.ndarray:
        """Trailing ``W`` tokens of one slot's (prompt + generated)
        history, host-side int32, sliced before concatenating."""
        tail = np.asarray(s.tokens[-W:], np.int32)
        need = W - tail.size
        if need <= 0:
            return tail
        return np.concatenate([prompt[-need:].astype(np.int32), tail])

    def _draft(self, s: "_Slot", prompt: np.ndarray) -> np.ndarray:
        """Prompt-lookup draft for one slot: the continuation of the most
        recent occurrence of the request's final ``spec_ngram`` tokens in
        its own history; empty when none.  Host numpy."""
        g, k = self.spec_ngram, self.spec_k
        h = self._history(s, prompt, self.spec_window)
        if h.size <= g:
            return h[:0]
        pat = h[-g:]
        win = np.lib.stride_tricks.sliding_window_view(h, g)[:-1]
        hits = np.flatnonzero((win == pat).all(axis=1))
        if hits.size == 0:
            return h[:0]
        start = int(hits[-1]) + g
        cont = h[start:start + k]
        if 0 < cont.size < k:       # repeat the tail past known history
            cont = np.concatenate([cont, np.full(k - cont.size, cont[-1], h.dtype)])
        return cont.astype(np.int32)

    def _verify_jit(self):
        """ONE verify callable for the lifetime: ``k+1`` positions per row at
        per-row cache offsets.  Row ``i`` accepts ``a_i`` = the leading
        drafted tokens equal to the model's own argmax (within its valid
        draft length ``d_i``); the boundary logits give the bonus token
        through the same selector as the plain step.  The counters come
        back at each row's committed position — stale K/V past it stays
        masked until overwritten (the ``rewind_cache`` contract, per row)."""
        return self._site("verify", self._verify_fn)

    def _verify_fn(self, toks, d, seeds, steps0, temps, top_ps):
        K = self.spec_k
        logits = self.model(toks, cache=self.cache)              # [B, K+1, V]
        greedy = torch.argmax(logits, dim=-1)
        ok = (toks[:, 1:] == greedy[:, :-1]) \
            & (torch.arange(K, device=toks.device)[None, :] < d[:, None])
        a = torch.cumprod(ok.long(), dim=1).sum(dim=1)          # [B] accepted
        bound = logits[torch.arange(toks.shape[0], device=toks.device), a]
        bonus = _select_tokens(bound, seeds, steps0 + a, temps, top_ps)
        for c in _counters(self.cache):     # advanced K+1; commit = pre + a + 1
            c.add_(a - K)
        return a, bonus

    def _slot_rows(self):
        """``(seeds, steps, temps, top_ps)`` of every slot as device tensors
        (empty slots: greedy defaults)."""
        return (self._tensor([s.seed if s else 0 for s in self.slots]),
                self._tensor([len(s.tokens) if s else 0 for s in self.slots]),
                self._tensor([s.temperature if s else 0.0 for s in self.slots],
                             torch.float32),
                self._tensor([s.top_p if s else 1.0 for s in self.slots], torch.float32))

    def _spec_step(self) -> list[int]:
        """One speculative decode step for every active slot: propose (the
        draft model when armed, else host-side prompt lookup), then one
        verify call commits each row's agreeing prefix plus the bonus."""
        K = self.spec_k
        B = self.max_batch
        dm = self._draft_model
        toks = np.zeros((B, K + 1), np.int64)
        d = np.zeros((B,), np.int64)
        elig: list[int] = []
        if dm is not None:
            buf = np.zeros((B, dm.window + K), np.int64)
            lens = np.ones((B,), np.int64)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            toks[i, :] = s.tokens[-1]
            if s.temperature <= 0 and s.remaining > 1:
                # sampled rows keep the draft-0 fallback: their token comes
                # from the verify call's boundary logits
                if dm is not None:
                    h = self._history(s, self._prompts[s.request_id], dm.window)
                    buf[i, :h.size] = h
                    lens[i] = h.size
                    elig.append(i)
                    continue
                dr = self._draft(s, self._prompts[s.request_id])
                di = min(dr.size, s.remaining - 1)
                if di > 0:
                    toks[i, 1:1 + dr.size] = dr
                    d[i] = di
        if dm is not None and elig:
            # ONE draft call proposes K tokens for every eligible row;
            # ineligible rows ride along masked (d=0)
            props = dm.propose(buf, lens, K)
            self.draft_dispatches += 1
            for i in elig:
                s = self.slots[i]
                toks[i, 1:1 + K] = props[i]
                d[i] = min(K, s.remaining - 1)
        if not d.any():
            # nothing drafted anywhere: the plain step, not a (K+1)-position
            # verify that commits one token a slot
            return self._plain_step()
        self.decode_dispatches += 1
        self.decode_steps += 1
        a, bonus = self._verify_jit()(self._tensor(toks), self._tensor(d), *self._slot_rows())
        a, bonus = torch.stack([a, bonus]).cpu().numpy()      # one host read
        self.spec_proposed += int(d.sum())
        self.spec_accepted += int(a.sum())
        for i in np.flatnonzero(d):
            self._accept_lens.append(int(a[i]))
        if len(self._accept_lens) > 65536:   # an undrained batcher: bound it
            del self._accept_lens[:-4096]
        done = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            new = list(toks[i, 1:1 + a[i]]) + [int(bonus[i])]
            for tok in new:
                s.tokens.append(int(tok))
                self._emit_token(s.request_id, int(tok))
                s.remaining -= 1
                if s.remaining <= 0 or tok == self.eos_id:
                    done.append(s.request_id)
                    self._finish(i, s)
                    break
        return done

    def _step_inner(self) -> list[int]:
        done = self._admit()
        if self.prefill_only:
            # prefill-pool posture: export each seated request's session
            # instead of decode-stepping it; the release in _finish keeps
            # the full prompt pages in the prefix index
            for i, s in enumerate(self.slots):
                if s is None or i in self._reserved:
                    continue
                self._sessions.append((s.request_id, self._export_session(s)))
                self.sessions_exported += 1
                self._finish(i, s)
            return done
        if not any(self.slots):
            return done
        if self.spec_k is not None:
            return done + self._spec_step()
        K = self._block_size()
        if K > 1:
            return done + self._block_step(K)
        return done + self._plain_step()

    def _block_size(self) -> int:
        """How many decode steps the next call may run: at most
        ``decode_block_steps`` and the minimum remaining budget over active
        slots (no slot overshoots), rounded down to a power of two.

        Admission latency rules: an in-flight chunked prefill forces single
        steps (its time slice is one chunk a step).  A queued request that
        cannot admit forces single steps only when ``eos_id`` is set — an
        eos can free a slot at ANY step.  Without eos no slot frees before
        the minimum remaining budget, so a block up to that bound delays
        the queued request by zero steps."""
        if self.decode_block_steps is None:
            return 1
        if self._inflight is not None:
            return 1
        if self._pending and self.eos_id is not None:
            return 1
        rem = min(s.remaining for s in self.slots if s is not None)
        cand = min(self.decode_block_steps, rem)
        if cand < 2:
            return 1
        return 1 << (cand.bit_length() - 1)

    def _block_jit(self, K: int, sampled: bool):
        """K decode steps in one call: each is the plain step verbatim, so
        the tokens equal K single calls' — one host read instead of K."""
        return self._site(("block", K, sampled), functools.partial(self._block_fn, K))

    def _block_fn(self, K: int, tokens, *sampling):
        """``sampling``: ``(seeds, steps0, temps, top_ps)``, or nothing for
        greedy."""
        seq = []
        for i in range(K):
            if sampling:
                seeds, steps0, temps, top_ps = sampling
                tokens = _decode_one_sampled(self.model, self.cache, tokens, seeds, steps0 + i,
                                             temps, top_ps)
            else:
                tokens = _decode_one_greedy(self.model, self.cache, tokens)
            seq.append(tokens)
        return torch.stack(seq, dim=1)

    def _block_step(self, K: int) -> list[int]:
        """ONE call, K committed decode steps.  A row that emits ``eos_id``
        mid-block keeps stepping (its later tokens are discarded here and
        its stale K/V is overwritten by the next admission)."""
        done: list[int] = []
        self.decode_dispatches += 1
        self.decode_steps += K
        tokens = self._tensor([s.tokens[-1] if s else 0 for s in self.slots])
        if any(s is not None and s.temperature > 0 for s in self.slots):
            seq = self._block_jit(K, True)(tokens, *self._slot_rows())
        else:
            seq = self._block_jit(K, False)(tokens)
        seq = seq.cpu().numpy()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            for tok in seq[i]:
                tok = int(tok)
                s.tokens.append(tok)
                self._emit_token(s.request_id, tok)
                s.remaining -= 1
                if s.remaining <= 0 or tok == self.eos_id:
                    done.append(s.request_id)
                    self._finish(i, s)
                    break
        return done

    def _plain_step(self) -> list[int]:
        done: list[int] = []
        self.decode_dispatches += 1
        self.decode_steps += 1
        tokens = self._tensor([s.tokens[-1] if s else 0 for s in self.slots])
        if any(s is not None and s.temperature > 0 for s in self.slots):
            nxt = self._step_sample(self.cache, tokens, *self._slot_rows())
        else:
            nxt = self._step(self.cache, tokens)
        nxt = nxt.cpu().numpy()                 # one host read for the batch
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok = int(nxt[i])
            s.tokens.append(tok)
            self._emit_token(s.request_id, tok)
            s.remaining -= 1
            if s.remaining <= 0 or tok == self.eos_id:
                done.append(s.request_id)
                self._finish(i, s)
        return done

    def result(self, request_id: int, *, pop: bool = False) -> np.ndarray | None:
        """Generated tokens of a FINISHED request (prompt excluded), or None
        while it is pending or decoding.  ``pop=True`` releases them."""
        if pop:
            return self._results.pop(request_id, None)
        return self._results.get(request_id)

    def run(self) -> dict[int, np.ndarray]:
        """Drive ``step()`` until every submitted request has finished;
        returns ``{request_id: generated tokens}`` (prompt excluded)."""
        while self._pending or self._pending_adopt or self._inflight is not None \
                or any(self.slots):
            self.step()
        return dict(self._results)
