"""Kernels of the port, each beside its plain PyTorch version."""

from tensorflowonspark_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_dkv, flash_attention_dkv_reference, flash_attention_dq,
    flash_attention_dq_reference, flash_attention_fwd, flash_attention_plain,
    flash_attention_reference)
