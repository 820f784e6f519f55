"""Continual learning: the standing train→eval→rollout loop.

Port of ``tensorflowonspark_tpu/continual/``.  It joins the training
plane to the serving tier: a training cluster continuously EMITS
candidates (checkpoints or adapter deltas) into the ``ModelRegistry`` via
:class:`CheckpointPublisher`; the batch plane GATES each candidate offline against a held-out eval manifest;
``RolloutController`` canaries the winner LIVE with windowed metrics
gates and auto-rollback — all journaled, so a driver failover resumes
mid-stage and an unvetted version can never serve a request.

    from tensorflowonspark_tpu_torch import continual

    # worker side (inside the training map_fun); base_sd is a float32
    # state dict, the saved state holds the model's under "model":
    pub = continual.CheckpointPublisher(ctx, "m", base=base_sd)
    pub.attach(ckpt_mngr, transform=lambda s: s["model"])

    # driver side, next to a live ServingCluster:
    pipe = continual.ContinualPipeline(serving, "m",
                                       base_builder=my_builder,
                                       eval_spec=continual.OfflineEval(...))
    pipe.run(trainer_fn, args, num_workers, data=stream)

Parameters travel as state dicts keyed by their names: deltas and
payloads are host numpy arrays, so their digests are this package's own
(the JAX package keys by flax paths).
"""

from tensorflowonspark_tpu_torch.continual.publisher import (  # noqa: F401
    CONTINUAL_QUEUES, PUBLISH_QUEUE, CheckpointPublisher, Publication,
    PublicationCollector, build_published_full, diff_params,
    flatten_params, payload_digest, payload_nbytes, replace_leaves)
from tensorflowonspark_tpu_torch.continual.pipeline import (  # noqa: F401
    OUTCOMES, ContinualPipeline, OfflineEval, candidate_trial_params)
