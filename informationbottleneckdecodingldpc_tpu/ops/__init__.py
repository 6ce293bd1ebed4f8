"""Compute building blocks: the node-update folds in jnp."""

from .lut_fold import (
    pairwise_lookup,
    cn_lut_leave_one_out,
    vn_lut_leave_one_out,
    vn_lut_full_fold,
)
from .float_ops import (
    boxplus,
    associative_leave_one_out,
    min_sum_op,
    cn_boxplus_leave_one_out,
    cn_minsum_leave_one_out,
    vn_sum_leave_one_out,
)

__all__ = [
    "pairwise_lookup",
    "cn_lut_leave_one_out",
    "vn_lut_leave_one_out",
    "vn_lut_full_fold",
    "boxplus",
    "associative_leave_one_out",
    "min_sum_op",
    "cn_boxplus_leave_one_out",
    "cn_minsum_leave_one_out",
    "vn_sum_leave_one_out",
]
