"""Discrete Information-Bottleneck lookup-table decoder.

Vectorized equivalent of the reference's integer LUT decoders
(Discrete_LDPC_decoding/discrete_LDPC_decoder.py:202-295 regular,
discrete_LDPC_decoder_irreg.py:245-341 irregular). Device-kernel semantics
are reproduced — they generated the published BER curves (SURVEY.md §7.4):

- initial check-node pass with the iteration-0 trellis tables;
- loop while ``i_num < imax`` and batch not converged: VN update with
  iteration ``i_num-1`` tables, CN update with iteration ``i_num`` tables
  (the kernel's ``iteration+1`` offset, kernels_template.cl:199-200), global
  syndrome test on the VN->CN messages;
- message-alignment remaps after each node op when matching tables are
  present: VN uses ``matching[i_num-1, d-1]``, in-loop CN uses
  ``matching[i_num, d-1]``, iteration-0 CN uses ``matching[0, d-1]``
  (kernels_template_irreg.cl:84-97,162-176,233-244);
- decision mapping folds channel plus all messages with the
  iteration-``i_num-1`` variable-node tables.

Hard-decision convention: cluster ``t < T/2`` decodes bit 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..construct.trellis import TrellisTables
from ..ops.lut_fold import (
    cn_lut_leave_one_out,
    vector_lookup,
    vn_lut_full_fold,
    vn_lut_leave_one_out,
)
from .common import (
    DecodeResult,
    apply_per_cn_group,
    apply_per_vn_group,
    gather_node_values_per_group,
    node_outputs_to_natural_order,
    run_message_passing_loop,
    unsatisfied_checks,
)
from .graph_arrays import DecodeLayout


@dataclasses.dataclass(frozen=True)
class DeviceTrellis:
    """Trellis tables as device arrays (int32)."""

    t_channel: int
    t_decoder: int
    i_max: int
    cn_iter0_first: jnp.ndarray
    cn_iter0_rest: jnp.ndarray  # [d_c_max-3, T, Tch]
    cn_rest: jnp.ndarray  # [i_max-1, d_c_max-2, T, T]
    vn_first: jnp.ndarray  # [i_max, Tch, T]
    vn_rest: jnp.ndarray  # [i_max, d_v_max-1, T, T]
    matching_cn: jnp.ndarray | None
    matching_vn: jnp.ndarray | None

    @classmethod
    def from_tables(cls, t: TrellisTables, use_matching: bool = True) -> "DeviceTrellis":
        as_i32 = lambda a: jnp.asarray(np.asarray(a), dtype=jnp.int32)
        return cls(
            t_channel=t.cardinality_t_channel,
            t_decoder=t.cardinality_t_decoder,
            i_max=t.i_max,
            cn_iter0_first=as_i32(t.cn_iter0_first),
            cn_iter0_rest=as_i32(t.cn_iter0_rest),
            cn_rest=as_i32(t.cn_rest),
            vn_first=as_i32(t.vn_first),
            vn_rest=as_i32(t.vn_rest),
            matching_cn=as_i32(t.matching_cn) if (use_matching and t.matching_cn is not None) else None,
            matching_vn=as_i32(t.matching_vn) if (use_matching and t.matching_vn is not None) else None,
        )


def _apply_matching(
    table_i: jnp.ndarray, degree: int, msgs: jnp.ndarray, vmax: int
) -> jnp.ndarray:
    """Remap messages through the alignment LUT row for this node degree."""
    return vector_lookup(table_i[degree - 1], msgs, vmax=vmax)


def ib_lut_decode(
    layout: DecodeLayout,
    trellis: DeviceTrellis,
    channel_clusters: jnp.ndarray,
    max_iters: int | None = None,
    early_exit: bool = True,
    convergence_reduce: Callable | None = None,
) -> DecodeResult:
    """Decode [n_vars, batch] channel cluster indices; returns cluster outputs."""
    imax = max_iters if max_iters is not None else trellis.i_max
    if imax > trellis.i_max:
        raise ValueError("max_iters exceeds constructed i_max")
    batch = channel_clusters.shape[-1]
    ch = channel_clusters.astype(jnp.int32)
    thresh = trellis.t_decoder // 2

    # Seed CN view with channel clusters
    # (send_channel_values_to_checknode_inbox, kernels_template.cl:13-30).
    cn_view0 = layout.seed_plan.apply(ch)
    ch_groups = gather_node_values_per_group(layout, ch)

    vmax = trellis.t_decoder

    def cn_update_iter0(msgs, grp):
        luts = [trellis.cn_iter0_first] + [
            trellis.cn_iter0_rest[l] for l in range(grp.degree - 3)
        ]
        out = cn_lut_leave_one_out(msgs, luts, vmax=vmax)
        if trellis.matching_cn is not None:
            out = _apply_matching(trellis.matching_cn[0], grp.degree, out, vmax)
        return out

    vn_view = layout.to_vn.apply(apply_per_cn_group(layout, cn_view0, cn_update_iter0))

    def body(state, i):
        (vn_view,) = state
        vn_first_i = jnp.take(trellis.vn_first, i, axis=0)
        vn_rest_i = jnp.take(trellis.vn_rest, i, axis=0)
        match_vn_i = (
            jnp.take(trellis.matching_vn, i, axis=0)
            if trellis.matching_vn is not None
            else None
        )

        def vn_update(chv, msgs, grp):
            d = grp.degree
            out = vn_lut_leave_one_out(
                chv, msgs, vn_first_i,
                [vn_rest_i[l] for l in range(max(d - 2, 0))],
                vmax=vmax,
            )
            if match_vn_i is not None and d > 1:
                out = _apply_matching(match_vn_i, d, out, vmax)
            return out

        vn_out = apply_per_vn_group(layout, vn_view, ch_groups, vn_update)
        cn_view = layout.to_cn.apply(vn_out)

        # CN update at DE iteration i+1 (the kernel's iteration+1 offset).
        cn_rest_i = jnp.take(trellis.cn_rest, i, axis=0)
        match_cn_i = (
            jnp.take(trellis.matching_cn, i + 1, axis=0)
            if trellis.matching_cn is not None
            else None
        )

        def cn_update(msgs, grp):
            out = cn_lut_leave_one_out(
                msgs, [cn_rest_i[l] for l in range(grp.degree - 2)], vmax=vmax
            )
            if match_cn_i is not None:
                out = _apply_matching(match_cn_i, grp.degree, out, vmax)
            return out

        new_vn_view = layout.to_vn.apply(apply_per_cn_group(layout, cn_view, cn_update))
        unsat = unsatisfied_checks(layout, cn_view < thresh)
        return (new_vn_view,), unsat

    (vn_view,), iters, unsat = run_message_passing_loop(
        (vn_view,),
        body,
        max_inner_iters=imax - 1,
        batch=batch,
        early_exit=early_exit,
        convergence_reduce=convergence_reduce,
    )

    # Decision mapping at iteration i_num - 1 = iters
    # (calc_varnode_output call, discrete_LDPC_decoder.py:279-288).
    dec_first = jnp.take(trellis.vn_first, iters, axis=0)
    dec_rest = jnp.take(trellis.vn_rest, iters, axis=0)
    outs = []
    for grp, chv in zip(layout.vn_groups, ch_groups):
        size = grp.num_nodes * grp.degree
        msgs = vn_view[grp.offset : grp.offset + size].reshape(
            grp.degree, grp.num_nodes, batch
        )
        outs.append(
            vn_lut_full_fold(
                chv, msgs, dec_first,
                [dec_rest[l] for l in range(max(grp.degree - 1, 0))],
                vmax=vmax,
            )
        )
    outputs = node_outputs_to_natural_order(layout, outs)
    return DecodeResult(outputs=outputs, iterations=iters, unsatisfied=unsat)
