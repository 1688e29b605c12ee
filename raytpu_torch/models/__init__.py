"""raytpu_torch.models: the Llama decoder (inference forwards and
training), GPT-2 (training and inference forwards), Mixtral for training,
the Train library's models (the fashion-MNIST MLP and ResNet), and the
converters from the JAX package's parameter trees."""

from raytpu_torch.models.convert import (gpt2_state_from_jax,
                                         llama_state_from_jax,
                                         mixtral_state_from_jax,
                                         mlp_state_from_jax,
                                         resnet_state_from_jax)
from raytpu_torch.models.gpt2 import (GPT2, GPT2Config, gpt2_decode,
                                      gpt2_loss_fn, gpt2_prefill,
                                      gpt2_prefill_chunk, make_train_step)
from raytpu_torch.models.llama import (Llama, LlamaConfig, llama_decode,
                                       llama_loss_fn, llama_prefill,
                                       llama_prefill_chunk)
from raytpu_torch.models.mixtral import (Mixtral, MixtralConfig, MoEFFN,
                                         mixtral_loss_fn)
from raytpu_torch.models.mlp import MLPClassifier, xent_loss
from raytpu_torch.models.resnet import ResNet, ResNetConfig

__all__ = ["GPT2", "GPT2Config", "Llama", "LlamaConfig", "MLPClassifier",
           "Mixtral", "MixtralConfig", "MoEFFN", "ResNet", "ResNetConfig",
           "gpt2_decode", "gpt2_loss_fn", "gpt2_prefill", "gpt2_prefill_chunk",
           "gpt2_state_from_jax", "llama_decode", "llama_loss_fn",
           "llama_prefill", "llama_prefill_chunk", "llama_state_from_jax",
           "make_train_step", "mixtral_loss_fn", "mixtral_state_from_jax",
           "mlp_state_from_jax", "resnet_state_from_jax", "xent_loss"]
