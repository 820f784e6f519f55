"""Reference-named façade: ``tensorflowonspark.gpu_info`` → this module.

``gpu_info.py::get_gpus`` picked free GPUs through ``nvidia-smi``; the
port's :mod:`~tensorflowonspark_tpu_torch.device_info` returns the ids of
the cards PyTorch sees.
"""

from tensorflowonspark_tpu_torch.device_info import get_gpus, num_local_devices  # noqa: F401
