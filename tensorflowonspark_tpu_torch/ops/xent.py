"""Memory-efficient LM-head cross-entropy, chunked over the vocabulary.

Port of ``tensorflowonspark_tpu/ops/xent.py``.  :func:`tied_softmax_xent`
computes

    loss[b, t] = logsumexp_v(h[b,t] @ W[v]) - h[b,t] @ W[label[b,t]]

without materialising the ``[B, T, V]`` logits: the forward runs an online
logsumexp over vocabulary chunks and picks up the label logit on the way;
the backward (a ``torch.autograd.Function``) recomputes each chunk's
probabilities from the saved logsumexp.  Activation memory is
``O(B·T·chunk)`` instead of ``O(B·T·V)``.

The chunk products are ``torch.matmul`` (the JAX version is ``lax.scan``
lowered by XLA, not a Pallas kernel).  Products are formed from operands in
the hidden states' dtype and accumulated in float32, as the JAX package's
``preferred_element_type=float32``; a ragged last chunk's missing columns
are masked to ``-inf``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _chunk_scores(h, table, c: int, chunk: int, V: int):
    """``(w, s)``: chunk ``c``'s table rows and its float32 scores
    ``[N, chunk]``, the columns past ``V`` (a ragged last chunk) at
    ``-inf``."""
    w = table[c * chunk:min((c + 1) * chunk, V)].to(h.dtype)
    s = torch.matmul(h.float(), w.float().T)
    if w.shape[0] < chunk:  # ragged tail: missing columns can't win
        s = F.pad(s, (0, chunk - w.shape[0]), value=-math.inf)
    return w, s


def _lse_and_label_logit(h, table, labels, chunk: int, V: int):
    """Online pass: ``(lse [N], label_logit [N])`` for flat ``h [N, H]``."""
    N = h.shape[0]
    m = torch.full((N,), -math.inf, device=h.device)
    l = torch.zeros((N,), device=h.device)
    ll = torch.zeros((N,), device=h.device)
    for c in range(-(-V // chunk)):
        _, s = _chunk_scores(h, table, c, chunk, V)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
        m = m_new
        # the label logit, if this chunk holds it
        idx = labels - c * chunk
        in_chunk = (idx >= 0) & (idx < chunk)
        picked = s.gather(1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
        ll = torch.where(in_chunk, picked, ll)
    return m + torch.log(l), ll


class _XentFlat(torch.autograd.Function):
    """Per-token losses of flat ``h [N, H]`` against ``table [V, H]``; the
    backward recomputes each chunk's softmax from the saved lse."""

    @staticmethod
    def forward(ctx, h, table, labels, chunk: int, V: int):
        lse, ll = _lse_and_label_logit(h, table, labels, chunk, V)
        ctx.save_for_backward(h, table, labels, lse)
        ctx.chunk, ctx.V = chunk, V
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        h, table, labels, lse = ctx.saved_tensors
        chunk, V = ctx.chunk, ctx.V
        gf = g.float()
        # float32 carry and accumulation: a bf16 running sum drifts from the
        # dense backward's single float32-accumulated matmul
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dws = []
        cols = torch.arange(chunk, device=h.device)
        for c in range(-(-V // chunk)):
            w, s = _chunk_scores(h, table, c, chunk, V)
            p = torch.exp(s - lse[:, None])                      # softmax chunk
            idx = labels - c * chunk
            in_chunk = (idx >= 0) & (idx < chunk)
            onehot = (idx.clamp(0, chunk - 1)[:, None] == cols[None, :]) & in_chunk[:, None]
            d = ((p - onehot.float()) * gf[:, None]).to(h.dtype)[:, :w.shape[0]]
            dh += torch.matmul(d.float(), w.float())
            dws.append(torch.matmul(d.float().T, h.float()))
        return dh.to(h.dtype), torch.cat(dws).to(table.dtype), None, None, None


def tied_softmax_xent(hidden, table, labels, *, chunk_size: int = 4096,
                      ignore_index: int | None = None):
    """Per-token cross-entropy of a (tied) LM head, chunked over the vocab.

    Args:
      hidden: ``[..., H]`` final hidden states (any leading shape).
      table: ``[V, H]`` projection/embedding table (``GPT``'s ``tok_emb``).
      labels: ``[...]`` integer targets in ``[0, V)``, the leading shape of
        ``hidden``.  A label in the ragged tail (``V <= label <
        padded V``) yields ``+inf``; any other stray value ``loss == lse``.
      chunk_size: vocab rows a step (clamped to V); a ragged last chunk's
        missing columns are masked out of both passes.
      ignore_index: tokens whose label equals it get loss 0 and no
        gradient (a multiply, so the cotangent into the chunked loss is 0).

    Returns per-token float32 losses ``[...]``; gradients flow to
    ``hidden`` and ``table``.
    """
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    V = table.shape[0]
    chunk = min(chunk_size, V)
    lead = hidden.shape[:-1]
    h = hidden.reshape(-1, hidden.shape[-1])
    flat_labels = labels.reshape(-1).long()
    if ignore_index is None:
        return _XentFlat.apply(h, table, flat_labels, chunk, V).reshape(lead)
    keep = flat_labels != ignore_index
    safe = torch.where(keep, flat_labels, 0)
    out = _XentFlat.apply(h, table, safe, chunk, V)
    return (out * keep.to(out.dtype)).reshape(lead)
