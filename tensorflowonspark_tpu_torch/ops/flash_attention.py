"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Port of ``tensorflowonspark_tpu/ops/flash_attention.py``.  The three TPU
kernels become CUDA C++ for ``sm_90a``: ``_fwd_kernel`` is
``csrc/flash_attention_fwd.cu``; ``_dq_kernel`` and ``_dkv_kernel`` are the
two kernels of ``csrc/flash_attention_bwd.cu``.  Each source is built with
``nvcc`` at first use into ``build/torch_kernels/`` (both at once, in
parallel) and called through a plain C entry point with ``ctypes``.  The
three bf16 kernels are built for Hopper from ``csrc/hopper.cuh``: TMA
tensor maps (encoded in C from the strides passed here), an
mbarrier-guarded ring of tiles and ``wgmma``.  The sources'
headers say what bounds them on the H100 and what their design does about
it.

:func:`flash_attention` keeps the JAX wrapper's contract: ``[B, T, H, D]``
in and out, an optional ``[B, Tk]`` bool key-padding mask (an additive
-1e30 bias), ``causal``, ``window`` (requires ``causal``), default scale
``1/sqrt(D)``, ragged ``Tq``/``Tk`` and ``Tq != Tk``.  A row with no
visible key returns zeros and gets zero gradients.  It is differentiable:
the autograd node saves ``(q, k, v, out, lse)`` and its backward runs the
dQ and dK/dV kernels.

Each launch is a ``torch.library`` custom op: ``tfos::flash_fwd``,
``tfos::flash_dq`` and ``tfos::flash_dkv``, defined and implemented
through a ``torch.library.Library`` (whose dispatch costs a few
microseconds a call, where ``torch.library.custom_op``'s Python layer
costs several times that: ``PERF.md``).  Their CUDA implementations
launch the kernels or raise; their CPU implementations run
:func:`flash_attention_reference` and the plain backward, the plain
PyTorch versions of the same arithmetic; their fake implementations give
the output shapes, so ``torch.export`` records the ops themselves in a
program (``checkpoint.export_model``) and the program launches the same
kernels when it runs on the card.  The kernels take head dims 64 and 128;
on the card any other ``D`` up to 128 is zero-padded to 64 or 128 (the
scale stays ``1/sqrt(D)``) and the outputs sliced back, which is exact:
zero columns add nothing to ``q.k^T``, and the padded columns of every
output are zero.  ``D > 128`` raises.  :func:`flash_attention_plain` runs
the plain versions on any device (the yardstick the card's kernels are
held against).
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
import torch.nn.functional as F

NEG_INF = -1e30  # large-negative mask value (avoids -inf − -inf = nan)
_EPS = 1e-30

#: kernel sources (each built into its own library) and the header they share
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = {"flash_attention_fwd": "flash_attention_fwd.cu",
            "flash_attention_bwd": "flash_attention_bwd.cu"}
_HEADERS = ("flash_attention_common.cuh", "hopper.cuh")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
#: the largest head dim the card takes (the kernels' widest tile)
MAX_HEAD_DIM = 128

_libs = None
_lib_lock = threading.Lock()
#: guards the launch counts: several threads may serve one exported
#: program at once, and ``x += 1`` on an attribute is not atomic
_count_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the flash-attention "
                       "kernels are built from source at first use")


def build_kernels() -> dict[str, str]:
    """Compile each kernel source into ``BUILD_DIR`` unless a library built
    from the same sources and flags is already there; return
    ``{name: path}``.

    The libraries' names carry one hash of every source, the shared header
    and the flags, so an edit to any of them rebuilds both.  The ``nvcc``
    processes run at once, one a source.  Each library is written under a
    temporary name and renamed, so processes that build at once never load
    a half-written file.  The compiler's report (registers, shared memory,
    spills) is kept beside each as ``.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted((*_SOURCES.values(), *_HEADERS)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    paths = {name: os.path.join(BUILD_DIR, f"{name}.{digest}.so") for name in _SOURCES}
    todo = [name for name, so in paths.items() if not os.path.exists(so)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, _SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {_SOURCES[name]} failed ({proc.returncode}):\n{err}")
            continue
        with open(paths[name][:-3] + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def _library(name: str):
    """The loaded library of kernel source ``name``, its entry points typed."""
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = build_kernels()
            libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
            fwd = libs["flash_attention_fwd"].tfos_flash_attention_fwd
            fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                            + [ctypes.c_longlong] * 9
                            + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p])
            shape = ([ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            bwd = libs["flash_attention_bwd"]
            bwd.tfos_flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + shape
            bwd.tfos_flash_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 9 + shape
            for lib in libs.values():
                lib.tfos_cuda_error_string.argtypes = [ctypes.c_int]
                lib.tfos_cuda_error_string.restype = ctypes.c_char_p
            fwd.restype = ctypes.c_int
            bwd.tfos_flash_attention_bwd_dq.restype = ctypes.c_int
            bwd.tfos_flash_attention_bwd_dkv.restype = ctypes.c_int
            _libs = libs
        return _libs[name]


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.tfos_cuda_error_string(err).decode())


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
    D = q.shape[3]
    window = _check_window(causal, window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    s = _scores(q, k, mask, causal, scale, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(_EPS)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    valid = m > NEG_INF * 0.5
    out = torch.where(valid, o / l, 0.0).to(q.dtype).transpose(1, 2)
    lse = torch.where(valid, m + torch.log(l), -NEG_INF)[..., 0]
    return out.contiguous(), lse


def _scores(q, k, mask, causal, scale, window):
    """The kernels' f32 scores ``[B, H, Tq, Tk]``: ``q.k^T * scale`` plus
    the key-padding bias, then causal/window masked to -1e30."""
    Tq, Tk = q.shape[1], k.shape[1]
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
    return s


def flash_attention_bwd_reference(q, k, v, mask, out, lse, dout,
                                  causal: bool = False,
                                  scale: float | None = None,
                                  window: int | None = None):
    """Plain PyTorch backward with the TPU kernels' arithmetic:
    ``(dq, dk, dv)`` in the q/k/v dtypes, ``[B, T, H, D]``.

    ``out`` and ``lse`` are the forward's (``[B, Tq, H, D]``,
    ``[B, H, Tq]`` float32) and ``dout`` the gradient of ``out``.  As
    ``_bwd_impl``: ``delta = rowsum(out * dout)`` in float32, then
    :func:`flash_attention_dq_reference` and
    :func:`flash_attention_dkv_reference`.  A fully masked row gives zero
    gradients.  It materialises the score matrix, so it is a reference,
    not a fast path.
    """
    delta = _delta(out, dout)
    dq = flash_attention_dq_reference(q, k, v, mask, dout, lse, delta, causal, scale, window)
    dk, dv = flash_attention_dkv_reference(q, k, v, mask, dout, lse, delta, causal,
                                           scale, window)
    return dq, dk, dv


def _delta(out, dout):
    """``rowsum(out * dout)`` in float32, ``[B, H, Tq]``."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def _p_dp(q, k, v, mask, dout, lse, delta, causal, scale, window):
    """``(p, ds, scale)`` of the backward, ``[B, H, Tq, Tk]`` float32:
    ``p`` recomputed from the saved log-sum-exp (masked keys, and every
    key of a fully masked row, whose lse is +1e30, give exactly 0),
    ``dp = dout . v^T`` and ``ds = p * (dp - delta)``."""
    window = _check_window(causal, window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[3])
    p = torch.exp(_scores(q, k, mask, causal, scale, window) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]), scale


def flash_attention_dq_reference(q, k, v, mask, dout, lse, delta,
                                 causal: bool = False, scale: float | None = None,
                                 window: int | None = None):
    """Plain ``dq`` as ``_dq_kernel`` computes it: ``ds`` rounded to k's
    dtype before ``ds . k``, then scaled; in q's dtype."""
    _, ds, scale = _p_dp(q, k, v, mask, dout, lse, delta, causal, scale, window)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, mask, dout, lse, delta,
                                  causal: bool = False, scale: float | None = None,
                                  window: int | None = None):
    """Plain ``(dk, dv)`` as ``_dkv_kernel`` computes them: ``p``, ``ds``,
    ``q`` and ``dout`` in float32, ``dv = p^T . dout``, ``dk = scale *
    ds^T . q``; in the k/v dtypes."""
    p, ds, scale = _p_dp(q, k, v, mask, dout, lse, delta, causal, scale, window)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels

def _check_window(causal: bool, window):
    if window is None:
        return None
    if not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def _rows_staged_ok(t) -> bool:
    """Head_dim contiguous and, for bf16, a base on 16 bytes and strides
    of whole 16 bytes: the bf16 kernels read q, k, v and dO through TMA
    tensor maps, which need both."""
    return t.stride(3) == 1 and (t.dtype != torch.bfloat16 or not (
        t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])))


def _check_kernel_inputs(q, k, v, mask):
    """Raise on what the kernels cannot take; return the mask as the
    kernels read it (contiguous bool, or None)."""
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
        raise ValueError(f"kernel takes head_dim 64 or 128 (the wrappers pad "
                         f"others up to {MAX_HEAD_DIM}), got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous (stride 1)")
        if not _rows_staged_ok(t):
            raise ValueError(f"bf16 {name} must start on 16 bytes with strides "
                             f"of whole 8-element groups, got {t.stride()}")
    if Tq == 0 or Tk == 0 or B == 0 or H == 0:
        raise ValueError("empty attention input")
    if mask is not None:
        if mask.shape != (B, Tk) or mask.device != q.device:
            raise ValueError(f"mask must be [B, Tk] = {(B, Tk)} on {q.device}")
        mask = mask.to(torch.bool).contiguous()
    return mask


def _scale(q, scale) -> float:
    """The score scale: ``scale`` or ``1/sqrt(D)`` of q's true head dim."""
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[3])


def _padded_head_dim(D: int) -> int:
    """The kernel head dim that takes ``D``: 64 up to 64, else 128."""
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention on the card takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    return 64 if D <= 64 else 128


def _pad_head(D: int, *ts):
    """``ts`` zero-padded along the head dim to the kernel's width."""
    Dp = _padded_head_dim(D)
    return ts if Dp == D else tuple(F.pad(t, (0, Dp - D)) for t in ts)


def _cut_head(D: int, *ts):
    """``ts`` cut back to head dim ``D``, contiguous."""
    return tuple(t if t.shape[3] == D else t[..., :D].contiguous() for t in ts)


def flash_attention_fwd(q, k, v, mask=None, causal: bool = False,
                        scale: float | None = None, window: int | None = None):
    """Forward ``(out, lse)`` through ``tfos::flash_fwd``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.  Shapes as
    :func:`flash_attention_reference`."""
    window = _check_window(causal, window)
    return torch.ops.tfos.flash_fwd(q, k, v, mask, bool(causal), _scale(q, scale),
                                    window or 0)


def _fwd_launch(q, k, v, mask, causal: bool, scale: float, window: int):
    """Launch the forward kernel (head dim 64 or 128) into new tensors."""
    mask = _check_kernel_inputs(q, k, v, mask)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _library("flash_attention_fwd")
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
            scale, int(causal), window, stream)
    _raise_on(lib, err, "flash-attention forward")
    return out, lse


_SCHEMA_ARGS = "bool causal, float scale, int window"
_BWD_SCHEMA = (f"(Tensor q, Tensor k, Tensor v, Tensor? mask, Tensor dout, Tensor lse, "
               f"Tensor delta, {_SCHEMA_ARGS})")
#: the ops' namespace; the ops live as long as this object
_LIB = torch.library.Library("tfos", "DEF")
_LIB.define(f"flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, {_SCHEMA_ARGS}) "
            "-> (Tensor, Tensor)")
_LIB.define(f"flash_dq{_BWD_SCHEMA} -> Tensor")
_LIB.define(f"flash_dkv{_BWD_SCHEMA} -> (Tensor, Tensor)")


def _fwd_padded(q, k, v, mask, causal, scale, window):
    """``tfos::flash_fwd`` on the card: the forward kernel, ``D`` padded
    to the kernel's width."""
    D = q.shape[3]
    out, lse = _fwd_launch(*_pad_head(D, q, k, v), mask, causal, scale, window)
    with _count_lock:
        flash_attention.launches += 1
    return _cut_head(D, out)[0], lse


def _fwd_cpu(q, k, v, mask, causal, scale, window):
    """``tfos::flash_fwd`` on the CPU: the plain version."""
    return flash_attention_reference(q, k, v, mask, causal, scale, window or None)


_LIB.impl("flash_fwd", _fwd_padded, "CUDA")
_LIB.impl("flash_fwd", _fwd_cpu, "CPU")


@torch.library.register_fake("tfos::flash_fwd")
def _flash_fwd_fake(q, k, v, mask, causal, scale, window):
    B, Tq, H, _ = q.shape
    return torch.empty_like(q, memory_format=torch.contiguous_format), \
        q.new_empty((B, H, Tq), dtype=torch.float32)


def flash_attention_bwd(q, k, v, mask, out, lse, dout, causal: bool = False,
                        scale: float | None = None, window: int | None = None):
    """Backward ``(dq, dk, dv)``: the dQ and dK/dV CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors.  Arguments as
    :func:`flash_attention_bwd_reference`.

    ``delta = rowsum(out * dout)`` stays one PyTorch expression here, as it
    is outside the Pallas kernels in JAX.  ``flash_attention_bwd.launches_dq``
    and ``.launches_dkv`` count each kernel's launches in this process.
    """
    delta = _delta(out, dout)
    dq = flash_attention_dq(q, k, v, mask, dout, lse, delta, causal, scale, window)
    dk, dv = flash_attention_dkv(q, k, v, mask, dout, lse, delta, causal, scale, window)
    return dq, dk, dv


def _bwd_launch(entry: str, outputs, q, k, v, mask, dout, lse, delta, causal,
                scale, window):
    """Check the inputs of one backward kernel (head dim 64 or 128) and
    launch it into ``outputs`` (allocated by the caller, ``[B, T, H, D]``
    contiguous).

    ``dout`` is read through its strides; one whose head_dim is not
    contiguous, or (bf16) whose rows do not start on 16 bytes, is first
    copied contiguous."""
    mask = _check_kernel_inputs(q, k, v, mask)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Tq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be [B, H, Tq] = {(B, H, Tq)} float32 on "
                             f"{q.device}")
    if not _rows_staged_ok(dout):
        dout = dout.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
            B, H, Tq, Tk, D, _KERNEL_DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            scale, int(causal), window,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, entry)


def flash_attention_dq(q, k, v, mask, dout, lse, delta, causal: bool = False,
                       scale: float | None = None, window: int | None = None):
    """``dq`` through ``tfos::flash_dq``: the dQ kernel (the TPU's
    ``_dq_kernel``) for CUDA tensors, :func:`flash_attention_dq_reference`
    for CPU tensors; ``delta`` is ``rowsum(out * dout)`` as ``[B, H, Tq]``
    float32."""
    window = _check_window(causal, window)
    return torch.ops.tfos.flash_dq(q, k, v, mask, dout, lse, delta, bool(causal),
                                   _scale(q, scale), window or 0)


def flash_attention_dkv(q, k, v, mask, dout, lse, delta, causal: bool = False,
                        scale: float | None = None, window: int | None = None):
    """``(dk, dv)`` through ``tfos::flash_dkv``: the dK/dV kernel (the TPU's
    ``_dkv_kernel``) for CUDA tensors, :func:`flash_attention_dkv_reference`
    for CPU tensors; arguments as :func:`flash_attention_dq`."""
    window = _check_window(causal, window)
    return torch.ops.tfos.flash_dkv(q, k, v, mask, dout, lse, delta, bool(causal),
                                    _scale(q, scale), window or 0)


def _dq_padded(q, k, v, mask, dout, lse, delta, causal, scale, window):
    """``tfos::flash_dq`` on the card: the dQ kernel, ``D`` padded to the
    kernel's width."""
    D = q.shape[3]
    q, k, v, dout = _pad_head(D, q, k, v, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("tfos_flash_attention_bwd_dq", (dq,), q, k, v, mask, dout, lse, delta,
                causal, scale, window)
    with _count_lock:
        flash_attention_bwd.launches_dq += 1
    return _cut_head(D, dq)[0]


def _dq_cpu(q, k, v, mask, dout, lse, delta, causal, scale, window):
    """``tfos::flash_dq`` on the CPU: the plain version."""
    return flash_attention_dq_reference(q, k, v, mask, dout, lse, delta, causal, scale,
                                        window or None)


_LIB.impl("flash_dq", _dq_padded, "CUDA")
_LIB.impl("flash_dq", _dq_cpu, "CPU")


@torch.library.register_fake("tfos::flash_dq")
def _flash_dq_fake(q, k, v, mask, dout, lse, delta, causal, scale, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _dkv_padded(q, k, v, mask, dout, lse, delta, causal, scale, window):
    """``tfos::flash_dkv`` on the card: the dK/dV kernel, ``D`` padded to
    the kernel's width."""
    D = q.shape[3]
    q, k, v, dout = _pad_head(D, q, k, v, dout)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("tfos_flash_attention_bwd_dkv", (dk, dv), q, k, v, mask, dout, lse,
                delta, causal, scale, window)
    with _count_lock:
        flash_attention_bwd.launches_dkv += 1
    return _cut_head(D, dk, dv)


def _dkv_cpu(q, k, v, mask, dout, lse, delta, causal, scale, window):
    """``tfos::flash_dkv`` on the CPU: the plain version."""
    return flash_attention_dkv_reference(q, k, v, mask, dout, lse, delta, causal, scale,
                                         window or None)


_LIB.impl("flash_dkv", _dkv_padded, "CUDA")
_LIB.impl("flash_dkv", _dkv_cpu, "CPU")


@torch.library.register_fake("tfos::flash_dkv")
def _flash_dkv_fake(q, k, v, mask, dout, lse, delta, causal, scale, window):
    return (torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class _FlashAttention(torch.autograd.Function):
    """Autograd node: the forward keeps ``(q, k, v, out, lse)`` and the
    mask; the backward recomputes the probabilities from ``lse`` in the
    dQ and dK/dV kernels (``plain``: in their plain versions).  The mask
    is bool and gets no gradient, as the JAX bias gets a zero cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, window, plain):
        fwd = flash_attention_reference if plain else flash_attention_fwd
        out, lse = fwd(q, k, v, mask, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        ctx.args = (causal, scale, window, plain)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, window, plain = ctx.args
        bwd = flash_attention_bwd_reference if plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, ctx.mask, out, lse, grad_out, causal, scale, window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: float | None = None, window: int | None = None):
    """Fused attention over ``[batch, seq, heads, head_dim]`` tensors.

    Drop-in ``attention_fn`` for ``models.bert.SelfAttention``;
    differentiable with respect to ``q``, ``k`` and ``v``.

    Args:
      q, k, v: ``[B, T, H, D]`` (q's T may differ from k/v's).  On the
        card: float32 or bfloat16, ``D`` at most 128 (64 and 128 run as
        they are, others zero-padded to 64 or 128), head_dim contiguous
        (other strides are read as they are; bf16 rows must start on 16
        bytes, as every view of a contiguous tensor's full head does).
      mask: optional ``[B, Tk]`` bool key-padding mask (True = attend).  A
        row with *no* visible key yields zeros and zero gradients.
      causal: causal masking by absolute position.
      window: sliding-window attention — each query attends to its last
        ``window`` keys only (itself included); requires ``causal=True``.
      scale: score scale, default ``1/sqrt(D)``.

    ``flash_attention.launches`` counts forward-kernel launches in this
    process (real launches only: a fake call while ``torch.export``
    traces counts none); ``flash_attention_bwd.launches_dq``/
    ``.launches_dkv`` the backward's.
    """
    return _FlashAttention.apply(q, k, v, mask, causal, scale, window, False)


flash_attention.launches = 0


def flash_attention_plain(q, k, v, mask=None, causal: bool = False,
                          scale: float | None = None, window: int | None = None):
    """:func:`flash_attention` through the plain versions, forward and
    backward, on any device: the yardstick the kernels are held against."""
    return _FlashAttention.apply(q, k, v, mask, causal, scale, window, True)
