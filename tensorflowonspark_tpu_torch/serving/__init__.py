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
errors, elastic membership, model labels and traffic splits, role-aware
disaggregated routing), ``replica`` (the worker map_fun; drains under
preemption, serves peer weight clones, hot-swaps model versions,
specializes on ``serve_role``), ``disagg`` (disaggregated prefill/decode
pools: role arithmetic and the pool map_fun; sessions move as KV-page
transfers), ``standby`` (warm standbys: spare replicas with their serve
steps already run — captured, with the capture cache — that heal paths
promote instead of cold-spawning, re-armed per role or model version at
promotion), ``rollout`` (``ModelRegistry`` with its offline-eval gate and
``RolloutController``: canary traffic shifting with metrics-gated
auto-rollback), ``frontend`` (the TCP edge and ``ServingCluster``:
add/retire/scale-up, deploy/swap/rollout, drain-and-replace, per-pool
autoscaling, the driver crash), ``autoscaler`` (metrics-driven
membership, promotes standbys first), ``client`` (``ServeClient``;
``failover_wait=`` rides through driver failovers), ``aot``
(``AOTExecutableCache``: each serve-step site of the batcher captured
once as a CUDA graph), ``journal`` (the write-ahead control-plane
journal), ``failover`` (``resume_driver``/``resume_rollouts``) and
``sharded`` (mesh-sharded gangs: a tp model instance cut across worker
processes that the tier routes to as one replica).
"""

from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache  # noqa: F401
from tensorflowonspark_tpu_torch.serving.autoscaler import (Autoscaler,  # noqa: F401
                                                            AutoscalerConfig)
from tensorflowonspark_tpu_torch.serving.client import (FrontendUnavailable,  # noqa: F401
                                                        ServeClient)
from tensorflowonspark_tpu_torch.serving.disagg import serve_disagg_replica  # noqa: F401
from tensorflowonspark_tpu_torch.serving.failover import (resume_driver,  # noqa: F401
                                                          resume_rollouts)
from tensorflowonspark_tpu_torch.serving.frontend import (ServeFrontend,  # noqa: F401
                                                          ServingCluster)
from tensorflowonspark_tpu_torch.serving.journal import (ControlPlaneJournal,  # noqa: F401
                                                         JournalState)
from tensorflowonspark_tpu_torch.serving.replica import serve_replica  # noqa: F401
from tensorflowonspark_tpu_torch.serving.rollout import (ModelRegistry,  # noqa: F401
                                                         ModelVersion, RolloutController,
                                                         RolloutError, RolloutPolicy,
                                                         apply_adapter)
from tensorflowonspark_tpu_torch.serving.sharded import (GangShardLost, GangSpec,  # noqa: F401
                                                         serve_sharded_replica)
from tensorflowonspark_tpu_torch.serving.scheduler import (PRIORITIES,  # noqa: F401
                                                           DeadlineExceeded, ReplicaFailed,
                                                           ReplicaScheduler, RequestRejected,
                                                           ServeRequest, ServingError,
                                                           TokenBucket)
from tensorflowonspark_tpu_torch.serving.standby import (StandbyPool,  # noqa: F401
                                                         serve_standby)
