"""Grid search over the batch plane: K trials multiplexed on ONE cluster.

The reference runs hyper-parameter search as Spark-ML ``CrossValidator``/
``TrainValidationSplit`` over ``TFEstimator`` — one full cluster job per
candidate.  Here the trials share the cluster: the manifest is expanded
once per trial (:meth:`~tensorflowonspark_tpu_torch.batch.manifest.ShardManifest.
with_trials`), every shard task carries its trial's param dict, and the
one :class:`~tensorflowonspark_tpu_torch.batch.job.BatchJob` dispatcher streams
all K×N tagged shards through the same workers — so trial K never waits
for trial K-1's stragglers and a restart resumes mid-grid (the ledger
keys on ``shard@trial``).

``param_grid`` accepts either an explicit list of param dicts or a
dict-of-lists (expanded as the cross product, like
``sklearn.model_selection.ParameterGrid`` /
``pipeline.ParamGridBuilder``)::

    gs = GridSearch(manifest, "/out", predict_fn,
                    param_grid={"temperature": [0.0, 0.7], "beam": [1, 4]},
                    model_builder=my_builder)
    summary = gs.run(num_workers=4)
    outputs = gs.trial_results("t0")     # merged records for trial t0
    gs.trials                            # {"t0": {...params...}, ...}
"""

from __future__ import annotations

import itertools
import logging

from tensorflowonspark_tpu_torch.batch.job import BatchJob
from tensorflowonspark_tpu_torch.batch.manifest import ShardManifest
from tensorflowonspark_tpu_torch.batch.writer import read_results

logger = logging.getLogger(__name__)


def expand_param_grid(param_grid) -> dict[str, dict]:
    """``{trial_id: params}`` from a list of dicts or a dict-of-lists
    (cross product over sorted keys, so trial ids are deterministic)."""
    if isinstance(param_grid, dict):
        keys = sorted(param_grid)
        combos = [dict(zip(keys, vals))
                  for vals in itertools.product(*(param_grid[k] for k in keys))]
    else:
        combos = [dict(p) for p in param_grid]
    if not combos:
        raise ValueError("empty param grid")
    return {f"t{i}": params for i, params in enumerate(combos)}


class GridSearch:
    """Bulk-predict every manifest shard once per trial (module docstring).

    Accepts every :class:`~tensorflowonspark_tpu_torch.batch.job.BatchJob`
    keyword (``batch_size=``, ``prefetch=``, ``predict_args=``, ...);
    ``predict_fn(model, records, trial_params)`` receives each shard's
    trial params as its third argument.
    """

    def __init__(self, manifest: ShardManifest, output_dir: str, predict_fn,
                 param_grid, **job_kwargs):
        self.trials = expand_param_grid(param_grid)
        self.base_manifest = manifest
        self.output_dir = output_dir
        self.job = BatchJob(manifest.with_trials(list(self.trials)),
                            output_dir, predict_fn,
                            trial_params=self.trials, **job_kwargs)

    def run(self, num_workers: int = 2, **run_kwargs) -> dict:
        """Run the expanded job; returns the dispatch summary plus the
        trial table (``{"trials": {tid: params}, ...}``)."""
        logger.info("grid search: %d trial(s) x %d shard(s) over %d "
                    "worker(s)", len(self.trials), len(self.base_manifest),
                    num_workers)
        summary = dict(self.job.run(num_workers, **run_kwargs))
        summary["trials"] = dict(self.trials)
        return summary

    def trial_manifest(self, trial_id: str) -> ShardManifest:
        """The expanded manifest restricted to one trial (output order)."""
        if trial_id not in self.trials:
            raise KeyError(f"unknown trial {trial_id!r} "
                           f"(have {sorted(self.trials)})")
        return ShardManifest(
            [s for s in self.job.manifest if s.trial == trial_id])

    def trial_results(self, trial_id: str, decode: bool = False) -> list:
        """One trial's merged output records, manifest order."""
        return read_results(self.output_dir, self.trial_manifest(trial_id),
                            decode=decode)

    def score(self, scorer, decode: bool = False) -> dict:
        """``{trial_id: scorer(results)}`` over every trial's merged
        output — the offline-eval surface the serving registry's
        promotion gate consumes
        (:meth:`~tensorflowonspark_tpu_torch.serving.rollout.ModelRegistry.
        evaluate_grid` scores one trial; this scores them all, e.g. to
        pick the winning candidate before registering it)."""
        return {tid: scorer(self.trial_results(tid, decode=decode))
                for tid in self.trials}
