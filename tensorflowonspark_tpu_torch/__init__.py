"""tensorflowonspark_tpu_torch — the PyTorch/CUDA port of tensorflowonspark_tpu.

The JAX package ``tensorflowonspark_tpu`` is the reference; this package
faces it module by module (same file names, same public names) and runs on
an NVIDIA GPU, with every TPU kernel on its path rewritten as a CUDA kernel
under ``ops/csrc``.  It imports nothing of JAX and nothing of the JAX
package.

    from tensorflowonspark_tpu_torch import TPUCluster, InputMode
    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=InputMode.SPARK)
    preds = cluster.inference(rows)
    cluster.shutdown()

Entry points run on the card unless the caller passes ``device="cpu"``;
a missing GPU raises instead of falling back.
"""

__version__ = "0.1.0"

from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster  # noqa: E402,F401
from tensorflowonspark_tpu_torch.datafeed import DataFeed  # noqa: E402,F401
from tensorflowonspark_tpu_torch.node import NodeContext  # noqa: E402,F401
