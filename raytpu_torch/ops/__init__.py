"""raytpu_torch.ops: the port's attention and normalisation ops. Each
pairs a CUDA kernel written by hand for Hopper (``csrc/``, built by
``_native``) with a plain PyTorch version of the same function."""

from raytpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_reference)
from raytpu_torch.ops.fused import rmsnorm, rmsnorm_reference, swiglu
from raytpu_torch.ops.paged_attention import (gather_kv_pages,
                                              paged_attention,
                                              paged_attention_reference)

__all__ = ["flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_reference",
           "gather_kv_pages", "paged_attention", "paged_attention_reference",
           "rmsnorm", "rmsnorm_reference", "swiglu"]
