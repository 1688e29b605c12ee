"""raytpu_torch.models: the Llama decoder's inference forwards and the
converter from the JAX package's parameter tree."""

from raytpu_torch.models.convert import llama_state_from_jax
from raytpu_torch.models.llama import (Llama, LlamaConfig, llama_decode,
                                       llama_prefill, llama_prefill_chunk)

__all__ = ["Llama", "LlamaConfig", "llama_decode", "llama_prefill",
           "llama_prefill_chunk", "llama_state_from_jax"]
