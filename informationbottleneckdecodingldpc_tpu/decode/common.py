"""Shared decoder plumbing: iteration driver, group application, syndrome.

Reproduces the reference device-loop semantics exactly (SURVEY.md §3.2 and
§7.4): the message-passing loop runs while ``i_num < imax`` *and* the whole
batch has not converged (batch-global syndrome test,
discrete_LDPC_decoder.py:233-276) — i.e. at most ``imax - 1`` in-loop
iterations. Early exit is a ``lax.while_loop`` on a reduced scalar; under
sharding the reduction closes over a ``psum`` so all shards stay in lockstep,
mirroring the reference's single in-order queue.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from .graph_arrays import DecodeLayout


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DecodeResult:
    """Decoder output.

    ``outputs``: [n_vars, batch] posterior quantity (cluster index for the IB
    LUT decoder, LLR for BP/min-sum) in natural variable order.
    ``iterations``: scalar executed in-loop iteration count. The whole
    batch runs in lockstep until every codeword has converged, so this is
    one count for the batch; with ``early_exit=False`` it is
    ``max_iters - 1``.
    ``unsatisfied``: [batch] unsatisfied-check count at exit.
    """

    outputs: jnp.ndarray
    iterations: jnp.ndarray
    unsatisfied: jnp.ndarray


def apply_per_cn_group(
    layout: DecodeLayout, edge_array: jnp.ndarray, fn: Callable
) -> jnp.ndarray:
    """Apply fn(msgs[d, n, batch], group) -> [d, n, batch] over each
    check-node degree group (static slices of the slot-major decode layout)."""
    batch = edge_array.shape[-1]
    outs = []
    for grp in layout.cn_groups:
        size = grp.num_nodes * grp.degree
        msgs = edge_array[grp.offset : grp.offset + size].reshape(
            grp.degree, grp.num_nodes, batch
        )
        outs.append(fn(msgs, grp).reshape(size, batch))
    return jnp.concatenate(outs, axis=0)


def gather_node_values_per_group(
    layout: DecodeLayout, node_values: jnp.ndarray
) -> list[jnp.ndarray]:
    """Pre-gather per-VN-group node values (e.g. channel messages).

    Channel values are loop-invariant, so this row move is hoisted out of
    the decode loop and paid once per decode instead of once per iteration;
    the run-decomposed plan turns it into slice copies for structured codes.
    """
    ordered = layout.vn_gather_plan.apply(node_values)
    out, off = [], 0
    for grp in layout.vn_groups:
        out.append(ordered[off : off + grp.num_nodes])
        off += grp.num_nodes
    return out


def apply_per_vn_group(
    layout: DecodeLayout,
    edge_array: jnp.ndarray,
    node_values_per_group: list[jnp.ndarray],
    fn: Callable,
) -> jnp.ndarray:
    """Apply fn(ch[n, batch], msgs[d, n, batch], group) -> [d, n, batch] over
    each variable-node degree group; ``node_values_per_group`` comes from
    :func:`gather_node_values_per_group`."""
    batch = edge_array.shape[-1]
    outs = []
    for grp, ch in zip(layout.vn_groups, node_values_per_group):
        size = grp.num_nodes * grp.degree
        msgs = edge_array[grp.offset : grp.offset + size].reshape(
            grp.degree, grp.num_nodes, batch
        )
        outs.append(fn(ch, msgs, grp).reshape(size, batch))
    return jnp.concatenate(outs, axis=0)


def node_outputs_to_natural_order(
    layout: DecodeLayout, per_group_outputs: list[jnp.ndarray]
) -> jnp.ndarray:
    """Concatenate per-VN-group node results and restore variable order."""
    concat = jnp.concatenate(per_group_outputs, axis=0)
    return layout.vn_unperm_plan.apply(concat)


def unsatisfied_checks(layout: DecodeLayout, cn_view_bits: jnp.ndarray) -> jnp.ndarray:
    """Per-codeword count of unsatisfied checks from hard bits in CN view.

    Matches the reference's parity test over the check-node inbox (VN->CN
    messages), kernels_template.cl:292-314: syndrome of check c = XOR of its
    incoming messages' hard decisions.
    """
    batch = cn_view_bits.shape[-1]
    total = jnp.zeros((batch,), dtype=jnp.int32)
    for grp in layout.cn_groups:
        # XOR across the group's contiguous slot-major planes (elementwise
        # ops on whole planes; avoids a strided cross-plane reduction).
        n = grp.num_nodes
        parity = cn_view_bits[grp.offset : grp.offset + n]
        for j in range(1, grp.degree):
            off = grp.offset + j * n
            parity = parity ^ cn_view_bits[off : off + n]
        total = total + jnp.sum(parity.astype(jnp.int32), axis=0, dtype=jnp.int32)
    return total


def run_message_passing_loop(
    init_state: Any,
    body: Callable[[Any, jnp.ndarray], tuple[Any, jnp.ndarray]],
    max_inner_iters: int,
    batch: int,
    early_exit: bool = True,
    convergence_reduce: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
):
    """Run the message-passing loop over an arbitrary state pytree.

    ``body(state, i)`` returns ``(new_state, unsatisfied_per_codeword)``.
    ``convergence_reduce`` maps per-codeword unsatisfied counts to a scalar
    (default local sum; the sharded sim engine passes a psum'd version).
    Returns (final_state, iterations_run, last_unsatisfied).
    """
    reduce = convergence_reduce or (lambda u: jnp.sum(u))
    # Sentinel "not converged yet" state; convergence is tested on the count
    # of unconverged codewords (bounded by the global batch), not the raw
    # unsatisfied-check sum, so the reduction cannot overflow int32.
    # Derive it from the loop state so that, under shard_map, its
    # varying-axes type matches the body's per-shard output (while_loop
    # requires carry-in/carry-out type equality).
    leaves = jax.tree_util.tree_leaves(init_state)
    taint = (
        (leaves[0].reshape(-1)[0] * 0).astype(jnp.int32) if leaves else jnp.int32(0)
    )
    unsat0 = jnp.ones((batch,), dtype=jnp.int32) + taint

    if max_inner_iters <= 0:
        return init_state, jnp.asarray(0, jnp.int32), unsat0

    if not early_exit:
        def scan_body(carry, i):
            state, _ = carry
            state, unsat = body(state, i)
            return (state, unsat), None

        (state, unsat), _ = jax.lax.scan(
            scan_body, (init_state, unsat0), jnp.arange(max_inner_iters)
        )
        return state, jnp.asarray(max_inner_iters, jnp.int32), unsat

    def cond(carry):
        _, i, unsat = carry
        unconverged = (unsat > 0).astype(jnp.int32)
        return jnp.logical_and(i < max_inner_iters, reduce(unconverged) > 0)

    def step(carry):
        state, i, _ = carry
        state, unsat = body(state, i)
        return state, i + 1, unsat

    state, iters, unsat = jax.lax.while_loop(
        cond, step, (init_state, jnp.asarray(0, jnp.int32), unsat0)
    )
    return state, iters, unsat
