"""Distributed online serving over ContinuousBatcher replicas.

Port of ``tensorflowonspark_tpu/serving/``: a driver-side frontend and
scheduler that admit, shed, route and fail over generate requests across
a cluster of replica workers, each running the port's continuous batcher
on its card behind the node's queue/shm data plane.

    from tensorflowonspark_tpu_torch.serving import ServingCluster

    serving = ServingCluster.run(my_model_builder, num_replicas=2,
                                 max_batch=4, eos_id=50256)
    with serving.client() as c:
        tokens = c.generate(prompt_ids, max_new_tokens=64)
    serving.shutdown()

Layout: ``scheduler`` (tenant-aware admission/routing/failover, typed
errors, elastic membership), ``replica`` (the worker map_fun; drains
under preemption, serves peer weight clones), ``standby`` (warm standbys:
spare replicas with their serve steps already run — captured, with the
capture cache — that heal paths promote instead of cold-spawning),
``frontend`` (the TCP edge and ``ServingCluster``: add/retire/scale-up,
drain-and-replace), ``client`` (``ServeClient``) and ``aot``
(``AOTExecutableCache``: each serve-step site of the batcher captured
once as a CUDA graph).  Not ported yet: ``autoscaler``, ``disagg``,
``rollout``, ``journal`` and ``failover`` (ROADMAP A8c), ``sharded``
(A6).
"""

from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache  # noqa: F401
from tensorflowonspark_tpu_torch.serving.client import (FrontendUnavailable,  # noqa: F401
                                                        ServeClient)
from tensorflowonspark_tpu_torch.serving.frontend import (ServeFrontend,  # noqa: F401
                                                          ServingCluster)
from tensorflowonspark_tpu_torch.serving.replica import serve_replica  # noqa: F401
from tensorflowonspark_tpu_torch.serving.scheduler import (PRIORITIES,  # noqa: F401
                                                           DeadlineExceeded, ReplicaFailed,
                                                           ReplicaScheduler, RequestRejected,
                                                           ServeRequest, ServingError,
                                                           TokenBucket)
from tensorflowonspark_tpu_torch.serving.standby import (StandbyPool,  # noqa: F401
                                                         serve_standby)
