"""Models of the port."""

from tensorflowonspark_tpu_torch.models.bert import (  # noqa: F401
    Bert, BertConfig, BertForQuestionAnswering, EncoderLayer, SelfAttention,
    build_qa_model, init_params, params_from_flax)
