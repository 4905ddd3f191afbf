"""Models of the port: the Llama decoder (training forward with LoRA,
and the paged serving mode) and its LoRA adapters."""

from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
from sparkdl_tpu_torch.models.lora import (
    LoRADense,
    lora_mask,
    merge_lora_with,
)

__all__ = ["Llama", "LlamaConfig", "LoRADense", "init_weights", "lora_mask",
           "merge_lora_with"]
