"""Kernels of the port, each beside its plain PyTorch version."""

from tensorflowonspark_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_fwd, flash_attention_reference)
