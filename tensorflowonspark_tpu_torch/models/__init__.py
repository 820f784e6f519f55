"""Models of the port."""

from tensorflowonspark_tpu_torch.models.bert import (  # noqa: F401
    Bert, BertConfig, BertForQuestionAnswering, EncoderLayer, SelfAttention,
    build_qa_model, init_params, params_from_flax)
from tensorflowonspark_tpu_torch.models.mnist import MNISTNet  # noqa: F401
from tensorflowonspark_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, Bottleneck, CifarResNet, ResNet, ResNet18, ResNet34, ResNet50,
    conv7_stem_to_s2d_kernel, space_to_depth)
