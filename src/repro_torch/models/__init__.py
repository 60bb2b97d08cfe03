"""Model paths of the port (plain PyTorch around the kernels): the
dense/vlm, moe, ssm and hybrid families."""
from .layers import chunked_xent
from .transformer import (abstract_params, forward, init_params, logits_fn,
                          loss_fn, param_leaves)
from .decoding import (PAGED_FAMILIES, StackSpec, decode_step,
                       decode_step_paged, init_cache, pool_layout, prefill,
                       prefill_suffix)

__all__ = ["abstract_params", "chunked_xent", "forward", "init_params", "logits_fn", "loss_fn",
           "param_leaves",
           "decode_step", "decode_step_paged", "init_cache",
           "PAGED_FAMILIES", "StackSpec", "pool_layout", "prefill",
           "prefill_suffix"]
