"""BASELINE config 3 end to end on the CPU: TFEstimator.fit → TFModel.transform.

A tiny BERT QA (2 layers, hidden 64, 4 heads, T = 64, dropout 0, float32)
is fine-tuned through the reference's ``examples/bert/bert_squad.py::
train_fn`` under its ``TFEstimator`` (imported from its path, not edited),
and through the port's ``bert_squad.train_fn`` under the port's
``TFEstimator``, on the same rows and from the same flax initialisation
(carried into the port with ``models.bert.params_from_flax``), one CPU
worker each.  The reference's rows are ids only; the port's carry a mask
of ones and token types of zeros, which is what the reference model
assumes without them.

Tolerances: the weights read back from both exports agree within
``2 * lr * steps`` in max (Adam's first steps move a weight by ``lr`` in
the gradient's sign, which float32 noise can flip where the gradient is
~0) and 1e-6 in median; the spans that ``TFModel.transform`` gives (the
reference's export returns argmaxes, the port's the logits) agree on at
least 95% of rows.
"""

import importlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowonspark_tpu import dataframe as jax_df
from tensorflowonspark_tpu import pipeline as jax_pl
from tensorflowonspark_tpu.checkpoint import ExportedModel as JaxExportedModel
from tensorflowonspark_tpu.models.bert import BertConfig as JaxBertConfig
from tensorflowonspark_tpu.models.bert import BertForQuestionAnswering as JaxBertQA
from tensorflowonspark_tpu_torch import pipeline as pl
from tensorflowonspark_tpu_torch.checkpoint import ExportedModel
from tensorflowonspark_tpu_torch.dataframe import DataFrame
from tensorflowonspark_tpu_torch.examples.bert import bert_squad
from tensorflowonspark_tpu_torch.models.bert import params_from_flax

pytestmark = pytest.mark.integration

FLAGS = ["--cluster_size", "1", "--batch_size", "8", "--num_samples", "32",
         "--seq_len", "64", "--vocab_size", "1000", "--hidden_size", "64",
         "--num_layers", "2", "--num_heads", "4", "--dropout", "0"]
STEPS = 4  # 32 rows in batches of 8, one epoch


def _flax_init(args):
    """The reference ``train_fn``'s initialisation of its model, here."""
    cfg = JaxBertConfig(vocab_size=args.vocab_size, hidden_size=args.hidden_size,
                        num_layers=args.num_layers, num_heads=args.num_heads,
                        intermediate_size=args.hidden_size * 4,
                        max_position_embeddings=args.seq_len, dropout_rate=args.dropout,
                        dtype=jnp.float32)
    ids0 = jnp.ones((args.batch_size, args.seq_len), jnp.int32)
    params = JaxBertQA(cfg).init(jax.random.key(0), ids0)["params"]
    return jax.tree.map(np.asarray, flax.core.meta.unbox(params))


def test_bert_squad_pipeline_matches_reference(tmp_path):
    reference = importlib.import_module("examples.bert.bert_squad")
    args = bert_squad.parser().parse_args(FLAGS + ["--cpu", "--export_dir",
                                                   str(tmp_path / "port_export")])
    rows = bert_squad.make_rows(args)

    ref_args = jax_pl.Namespace(vars(args) | {"export_dir": str(tmp_path / "ref_export")})
    ref_df = jax_df.DataFrame([jax_df.Row(input_ids=r.input_ids.tolist(),
                                          start_position=r.start_position,
                                          end_position=r.end_position) for r in rows],
                              num_partitions=2)
    ref_model = (jax_pl.TFEstimator(reference.train_fn, ref_args,
                                    worker_env={"JAX_PLATFORMS": "cpu"})
                 .setClusterSize(1).setBatchSize(args.batch_size).setEpochs(1)
                 .setExportDir(ref_args.export_dir)
                 .setInputMapping({"input_ids": "input_ids"})
                 .setOutputMapping({"start": "pred_start", "end": "pred_end"})
                 .fit(ref_df))

    args.state_dict = params_from_flax(_flax_init(args))
    df = DataFrame(rows, num_partitions=2)
    model = (pl.TFEstimator(bert_squad.train_fn, args, device="cpu",
                            worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
             .setClusterSize(1).setBatchSize(args.batch_size).setEpochs(1)
             .setExportDir(args.export_dir)
             .setInputMapping(bert_squad.INPUT_MAPPING)
             .setOutputMapping(bert_squad.OUTPUT_MAPPING)
             .fit(df))

    want = params_from_flax(jax.tree.map(np.asarray, flax.core.meta.unbox(
        JaxExportedModel.load(ref_args.export_dir).params)))
    got = ExportedModel.load(args.export_dir, device="cpu").params
    assert set(want) <= set(got)
    diffs = np.concatenate([np.abs(got[n].numpy() - want[n].numpy()).ravel() for n in want])
    moved = np.concatenate([np.abs(got[n].numpy() - args.state_dict[n].numpy()).ravel()
                            for n in want])
    assert moved.max() > 0.5 * args.lr          # both trained
    assert diffs.max() <= 2 * args.lr * STEPS, diffs.max()
    assert np.median(diffs) <= 1e-6, np.median(diffs)

    ref_out = ref_model.transform(ref_df.select("input_ids")).collect()
    out = model.transform(df.select(*bert_squad.INPUT_MAPPING)).collect()
    ref_spans = np.array([(int(r.pred_start), int(r.pred_end)) for r in ref_out])
    spans = np.array([(int(np.argmax(r.pred_start)), int(np.argmax(r.pred_end))) for r in out])
    assert len(spans) == len(rows)
    assert np.mean(np.all(spans == ref_spans, axis=1)) >= 0.95
