"""Dense-family model path of the port (plain PyTorch around the kernels)."""
from .transformer import forward, init_params, logits_fn, param_leaves
from .decoding import (PAGED_FAMILIES, StackSpec, decode_step_paged,
                       pool_layout, prefill, prefill_suffix)

__all__ = ["forward", "init_params", "logits_fn", "param_leaves",
           "decode_step_paged", "PAGED_FAMILIES", "StackSpec", "pool_layout",
           "prefill", "prefill_suffix"]
