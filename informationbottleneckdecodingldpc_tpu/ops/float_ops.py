"""Float message-passing primitives for the BP / min-sum benchmark decoders.

Numerics match the reference OpenCL kernels
(Continous_LDPC_Decoding/kernels_min_and_BP.cl): LLR clamp at +/-150 applied
at variable-node outputs; the check-node box-plus never exceeds the magnitude
of its smallest input, so intermediate clamps in the reference's sequential
fold are vacuous and prefix/suffix evaluation is exact.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

LLR_MAX = 150.0


def boxplus(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Stable log-domain box-plus: 2 atanh(tanh(a/2) tanh(b/2)).

    Equivalent to log((1+e^{a+b})/(e^a+e^b)) (kernels_min_and_BP.cl:5-9)
    without overflow: sign(a)sign(b)min(|a|,|b|) + log1p-correction terms.
    """
    sgn = jnp.sign(a) * jnp.sign(b)
    mag = jnp.minimum(jnp.abs(a), jnp.abs(b))
    corr = jnp.log1p(jnp.exp(-jnp.abs(a + b))) - jnp.log1p(jnp.exp(-jnp.abs(a - b)))
    return sgn * mag + corr


def min_sum_op(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """sign(a b) min(|a|, |b|) — the reference's sequential min-sum step
    (kernels_min_and_BP.cl:156-161); sign(0) = 0 like OpenCL sign()."""
    return jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))


def associative_leave_one_out(
    op: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray], msgs: jnp.ndarray
) -> jnp.ndarray:
    """Leave-one-out fold of an associative op over axis 0 via prefix/suffix.

    msgs: [d, n, batch] slot-major planes; returns [d, n, batch] where output
    plane j combines all messages except j. Cost O(d) op applications (vs the
    reference's O(d^2) per-work-item chains).
    """
    d = msgs.shape[0]
    if d == 1:
        raise ValueError("leave-one-out undefined for degree-1 check nodes")
    if d == 2:
        return jnp.stack([msgs[1], msgs[0]], axis=0)
    prefix = [msgs[0]]
    for k in range(1, d - 1):
        prefix.append(op(prefix[-1], msgs[k]))
    suffix = [msgs[d - 1]]
    for k in range(d - 2, 0, -1):
        suffix.append(op(msgs[k], suffix[-1]))
    suffix.reverse()  # suffix[k-1] = fold(m_k..m_{d-1})
    outs = [suffix[0]]
    for j in range(1, d - 1):
        outs.append(op(prefix[j - 1], suffix[j]))
    outs.append(prefix[d - 2])
    return jnp.stack(outs, axis=0)


def cn_boxplus_leave_one_out(msgs: jnp.ndarray) -> jnp.ndarray:
    """BP check-node update (kernels_min_and_BP.cl:32-71)."""
    return associative_leave_one_out(boxplus, msgs)


def cn_minsum_leave_one_out(msgs: jnp.ndarray) -> jnp.ndarray:
    """Min-sum check-node update (kernels_min_and_BP.cl:126-167)."""
    return associative_leave_one_out(min_sum_op, msgs)


def sum_planes(msgs: jnp.ndarray) -> jnp.ndarray:
    """Sequential left-fold sum over axis 0 ((m0+m1)+m2)+... — an explicit
    reduction order, so every backend rounds identically (jnp.sum's grouping
    is compiler-chosen)."""
    s = msgs[0]
    for k in range(1, msgs.shape[0]):
        s = s + msgs[k]
    return s


def vn_sum_leave_one_out(ch: jnp.ndarray, msgs: jnp.ndarray) -> jnp.ndarray:
    """Variable-node update: channel + sum of other messages, clamped to
    +/-LLR_MAX (kernels_min_and_BP.cl:76-123). msgs is [d, n, batch]
    slot-major; degree-1 nodes forward the channel LLR."""
    d = msgs.shape[0]
    if d == 1:
        return jnp.clip(ch[None, :, :], -LLR_MAX, LLR_MAX)
    total = (ch + sum_planes(msgs))[None, :, :]
    return jnp.clip(total - msgs, -LLR_MAX, LLR_MAX)


def minsum_leave_one_out_planes(planes: list) -> list:
    """Min-sum leave-one-out over a plane LIST via min1/min2 + sign products.

    Bitwise-identical (up to the sign of zero) to the pairwise
    ``min_sum_op`` prefix/suffix fold: every output is (product of signs
    excluding j) x (min magnitude excluding j), and both factors are exact
    regardless of evaluation order — min-sum never creates new values.
    O(~9d) cheap elementwise ops per node instead of the pairwise fold's
    3(d-2) applications of the 7-op ``min_sum_op``.
    """
    d = len(planes)
    if d == 1:
        raise ValueError("leave-one-out undefined for degree-1 check nodes")
    if d == 2:
        return [planes[1], planes[0]]
    mags = [jnp.abs(p) for p in planes]
    sgns = [jnp.sign(p) for p in planes]
    # min1 = smallest magnitude, min2 = second smallest (== min1 on ties).
    min1 = mags[0]
    min2 = jnp.full_like(mags[0], jnp.inf)
    for a in mags[1:]:
        min2 = jnp.minimum(min2, jnp.maximum(min1, a))
        min1 = jnp.minimum(min1, a)
    # Leave-one-out sign products via prefix/suffix (zeros propagate).
    pre = [sgns[0]]
    for k in range(1, d - 1):
        pre.append(pre[-1] * sgns[k])
    suf = [sgns[-1]]
    for k in range(d - 2, 0, -1):
        suf.insert(0, sgns[k] * suf[0])
    out = []
    for j in range(d):
        if j == 0:
            s = suf[0]
        elif j == d - 1:
            s = pre[d - 2]
        else:
            s = pre[j - 1] * suf[j]
        mag = jnp.where(mags[j] == min1, min2, min1)
        out.append(s * mag)
    return out
