"""Models of the port: the Llama decoder (training forward with LoRA,
the paged and dense-slot serving modes, multi-LoRA) and its LoRA
adapters, and the model zoo of the reference's benchmark families
(BASELINE.json configs 1-3): the MNIST CNN, ResNet and BERT. The
serving-side modules (``generate``, ``serving``, ``speculative``,
``server``, ``fleet``, ``quant``) and the HuggingFace Llama conversion
(``convert``) are imported by path, as in the JAX package."""

from sparkdl_tpu_torch.models.bert import (
    Bert,
    BertConfig,
    BertForQuestionAnswering,
    BertForSequenceClassification,
)
from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
from sparkdl_tpu_torch.models.lora import (
    LoRADense,
    MultiLoRADense,
    lora_mask,
    merge_lora_with,
    stack_lora_adapters,
)
from sparkdl_tpu_torch.models.mnist_cnn import MnistCNN
from sparkdl_tpu_torch.models.resnet import ResNet, ResNet50

__all__ = ["Bert", "BertConfig", "BertForQuestionAnswering",
           "BertForSequenceClassification", "Llama", "LlamaConfig",
           "LoRADense", "MnistCNN", "MultiLoRADense", "ResNet", "ResNet50",
           "init_weights", "lora_mask", "merge_lora_with",
           "stack_lora_adapters"]
