"""Models of the port: the Llama decoder in its paged serving mode."""

from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig

__all__ = ["Llama", "LlamaConfig"]
