"""Models of the port: the Llama decoder (training forward with LoRA,
the paged and dense-slot serving modes, multi-LoRA) and its LoRA
adapters. The serving-side modules (``generate``, ``serving``,
``speculative``, ``server``, ``fleet``, ``quant``) are imported by
path, as in the JAX package."""

from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
from sparkdl_tpu_torch.models.lora import (
    LoRADense,
    MultiLoRADense,
    lora_mask,
    merge_lora_with,
    stack_lora_adapters,
)

__all__ = ["Llama", "LlamaConfig", "LoRADense", "MultiLoRADense",
           "init_weights", "lora_mask", "merge_lora_with",
           "stack_lora_adapters"]
