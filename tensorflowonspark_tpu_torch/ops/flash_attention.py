"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Port of ``tensorflowonspark_tpu/ops/flash_attention.py``.  The TPU kernel
``_fwd_kernel`` becomes ``csrc/flash_attention_fwd.cu`` (CUDA C++ for
``sm_90a``), built with ``nvcc`` at first use into ``build/torch_kernels/``
and called through a plain C entry point with ``ctypes``.  The source's
header says what bounds it on the H100 and what its design does about it.

:func:`flash_attention` keeps the JAX wrapper's contract: ``[B, T, H, D]``
in and out, an optional ``[B, Tk]`` bool key-padding mask (an additive
-1e30 bias), ``causal``, ``window`` (requires ``causal``), default scale
``1/sqrt(D)``, ragged ``Tq``/``Tk`` and ``Tq != Tk``.  A row with no
visible key returns zeros.  On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs :func:`flash_attention_reference`, the
plain PyTorch version of the same arithmetic.  The backward kernels (the
TPU's ``_dq_kernel`` and ``_dkv_kernel``) are not ported yet, so the
autograd ``backward`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch

NEG_INF = -1e30  # large-negative mask value (avoids -inf − -inf = nan)
_EPS = 1e-30

#: kernel source, and where it is built (a directory ``.gitignore`` lists)
_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "flash_attention_fwd.cu")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)

_lib = None
_lib_lock = threading.Lock()


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the flash-attention "
                       "kernel is built from source at first use")


def build_kernel() -> str:
    """Compile the kernel into ``BUILD_DIR`` unless a library built from
    the same source and flags is already there; return its path.

    The library's name carries a hash of the source and flags, so an edit
    rebuilds it.  It is written under a temporary name and renamed, so
    processes that build at once never load a half-written file.  The
    compiler's report (registers, shared memory, spills) is kept beside
    it as ``.log``."""
    with open(_SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"flash_attention_fwd.{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernel())
            fn = lib.tfos_flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.tfos_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tfos_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ------------------------------------------------------------ plain version

def flash_attention_reference(q, k, v, mask=None, causal: bool = False,
                              scale: float | None = None,
                              window: int | None = None):
    """Plain PyTorch forward with the kernel's semantics: ``(out, lse)``.

    ``out`` is ``[B, Tq, H, D]`` in q's dtype, ``lse`` is ``[B, H, Tq]``
    float32.  Scores are f32, scaled, plus the additive key-padding bias,
    then causal/window masked to -1e30; ``p`` is rounded to v's dtype
    before the ``p·V`` product while the normaliser sums the unrounded
    ``p``.  A row with no visible key gives ``out = 0`` and
    ``lse = +1e30``.  It materialises the whole score matrix, so it is a
    reference, not a fast path.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    window = _check_window(causal, window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        bias = torch.where(mask.bool(), 0.0, NEG_INF).to(torch.float32)
        s = s + bias[:, None, None, :]
    if causal:
        q_pos = torch.arange(Tq, device=q.device)[:, None]
        k_pos = torch.arange(Tk, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window is not None:
            keep = keep & (k_pos > q_pos - window)
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(_EPS)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    valid = m > NEG_INF * 0.5
    out = torch.where(valid, o / l, 0.0).to(q.dtype).transpose(1, 2)
    lse = torch.where(valid, m + torch.log(l), -NEG_INF)[..., 0]
    return out.contiguous(), lse


# ------------------------------------------------------------------ kernel

def _check_window(causal: bool, window):
    if window is None:
        return None
    if not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def flash_attention_fwd(q, k, v, mask=None, causal: bool = False,
                        scale: float | None = None, window: int | None = None):
    """Forward ``(out, lse)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Shapes as :func:`flash_attention_reference`.
    """
    window = _check_window(causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, causal, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != (B, Tk, H, D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim 64 or 128, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous (stride 1)")
        # the bf16 kernel stages rows with 16-byte loads
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
                st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} must start on 16 bytes with strides "
                             f"of whole 8-element groups, got {t.stride()}")
    if mask is not None:
        if mask.shape != (B, Tk) or mask.device != q.device:
            raise ValueError(f"mask must be [B, Tk] = {(B, Tk)} on {q.device}")
        mask = mask.to(torch.bool).contiguous()
    if Tq == 0 or Tk == 0 or B == 0 or H == 0:
        raise ValueError("empty attention input")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)

    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tfos_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
            _KERNEL_DTYPES[q.dtype],
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            scale, int(causal), window or 0, stream)
    if err != 0:
        raise RuntimeError("flash-attention kernel launch failed: "
                           + lib.tfos_cuda_error_string(err).decode())
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Autograd node around the forward.  Its backward needs the dQ and
    dK/dV kernels, which are still to be ported (ROADMAP, kernels K2/K3):
    training through it raises instead of going on silently."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, window):
        out, _ = flash_attention_fwd(q, k, v, mask, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward is not ported yet: it needs the dQ and "
            "dK/dV kernels (ROADMAP kernels K2/K3)")


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: float | None = None, window: int | None = None):
    """Fused attention over ``[batch, seq, heads, head_dim]`` tensors.

    Drop-in ``attention_fn`` for ``models.bert.SelfAttention``.

    Args:
      q, k, v: ``[B, T, H, D]`` (q's T may differ from k/v's).  On the
        card: float32 or bfloat16, ``D`` 64 or 128, head_dim contiguous
        (other strides are read as they are; bf16 rows must start on 16
        bytes, as every view of a contiguous tensor's full head does).
      mask: optional ``[B, Tk]`` bool key-padding mask (True = attend).  A
        row with *no* visible key yields zeros.
      causal: causal masking by absolute position.
      window: sliding-window attention — each query attends to its last
        ``window`` keys only (itself included); requires ``causal=True``.
      scale: score scale, default ``1/sqrt(D)``.

    ``flash_attention.launches`` counts kernel launches in this process.
    """
    return _FlashAttention.apply(q, k, v, mask, causal, scale, window)


flash_attention.launches = 0
