"""Kernels of the port, each beside its plain PyTorch version, and the ops
that XLA lowers in the JAX package (quantization, the chunked LM-head
loss), here in plain PyTorch."""

from tensorflowonspark_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_dkv, flash_attention_dkv_reference, flash_attention_dq,
    flash_attention_dq_reference, flash_attention_fwd, flash_attention_plain,
    flash_attention_reference)
from tensorflowonspark_tpu_torch.ops.quant import (  # noqa: F401
    Int4Array, Int4PackedArray, Int8Array, quantize_int4, quantize_int8,
    quantize_params, shard_quantized, tree_nbytes)
from tensorflowonspark_tpu_torch.ops.xent import tied_softmax_xent  # noqa: F401
