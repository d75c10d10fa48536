from .gpt import GPT, GPT2, GPTNeo, GPTNeoLarge, load_hf_state_dict, load_numpy_state_dict  # noqa: F401
from .bert import Bert, BertTiny, BertBase, BertLarge, plain_bert_forward  # noqa: F401
from .bert_classifier import (  # noqa: F401
    BertBaseForSequenceClassification,
    BertClassifierConfig,
    BertForSequenceClassification,
    BertTinyForSequenceClassification,
    load_safetensors,
    plain_classifier_forward,
)
from .resnet import (  # noqa: F401
    BasicBlock,
    Bottleneck,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
)
from . import generate  # noqa: F401
