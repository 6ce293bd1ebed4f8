"""Min-sum decoder (continuous-domain benchmark).

Vectorized equivalent of the reference's
``Min_Sum_Decoder_class_irregular.decode_OpenCL_min_sum``
(Continous_LDPC_Decoding/min_sum_decoder_irreg.py:221-287): seed check-node
inboxes with channel LLRs, then loop (CN min-sum update -> VN sum update ->
syndrome) for at most imax-1 iterations with batch-global early exit; output
is channel + all incoming messages (no clamp).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from ..ops.float_ops import cn_minsum_leave_one_out
from .common import DecodeResult
from .float_common import float_decode
from .graph_arrays import DecodeLayout


def min_sum_decode(
    layout: DecodeLayout,
    channel_llrs: jnp.ndarray,
    max_iters: int,
    early_exit: bool = True,
    convergence_reduce: Callable | None = None,
) -> DecodeResult:
    """Decode [n_vars, batch] channel LLRs with the min-sum rule."""
    return float_decode(
        layout,
        channel_llrs,
        max_iters,
        cn_update=lambda msgs, grp: cn_minsum_leave_one_out(msgs),
        early_exit=early_exit,
        convergence_reduce=convergence_reduce,
    )
