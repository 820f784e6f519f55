"""Models of the port."""

from tensorflowonspark_tpu_torch.models.bert import (  # noqa: F401
    Bert, BertConfig, BertForQuestionAnswering, BertForSequenceClassification,
    EncoderLayer, SelfAttention, build_qa_model, init_params, params_from_flax)
from tensorflowonspark_tpu_torch.models.mnist import MNISTNet  # noqa: F401
from tensorflowonspark_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, Bottleneck, CifarResNet, ResNet, ResNet18, ResNet34, ResNet50,
    conv7_stem_to_s2d_kernel, space_to_depth)
from tensorflowonspark_tpu_torch.models.inception import InceptionV3  # noqa: F401
from tensorflowonspark_tpu_torch.models.unet import UNet  # noqa: F401
from tensorflowonspark_tpu_torch.models.wide_deep import WideDeep  # noqa: F401
from tensorflowonspark_tpu_torch.models.gpt import (GPT, GPTConfig,  # noqa: F401
                                                    beam_generate, greedy_generate,
                                                    init_cache, lookup_generate,
                                                    sample_generate)
from tensorflowonspark_tpu_torch.models.serving import (ContinuousBatcher,  # noqa: F401
                                                        DraftModel)
from tensorflowonspark_tpu_torch.models.convert import (  # noqa: F401
    bert_config_from_hf, bert_params_from_hf, gpt2_config_from_hf,
    gpt2_params_from_hf, llama_config_from_hf, llama_params_from_hf)
