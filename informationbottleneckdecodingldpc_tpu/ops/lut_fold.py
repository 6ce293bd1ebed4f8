"""Leave-one-out trellis-LUT folds (the discrete decoder's node operations).

The reference kernels walk, per work item, an O(d^2) chain of scalar lookups
(kernels_template.cl:62-89,137-169). Here each same-degree node group is
processed as one dense ``[nodes, degree, batch]`` tensor; the per-output
chains share the full-chain prefix states, cutting lookups to ~d^2/2, and
every lookup is fully vectorized over the [nodes, batch] plane.

Lookup lowerings (``set_lookup_mode``):

- 'take' (default): one gather into the flattened LUT per lookup. The LUTs
  are at most 32x32 entries, so on the GPU every gather hits cache.
- 'select': a |T0|x|T1| compare-select tree, no gather.
- 'packed': each LUT *column* (fixed second operand b) packed into
  ceil(T0/per) int32 words of ``field_bits``-bit fields; selecting the
  column by b costs |T1| compares + |T1|*W selects, and each chained lookup
  is then one word select + a per-lane variable shift + mask. The
  leave-one-out chains reuse each (step-LUT, message) column across all
  outputs — the fold functions cache them. Int32 wrapping is harmless:
  packing wraps two's-complement bit patterns, the arithmetic right shift's
  sign-extension is masked off.

All three are bit-exact against each other (tests/test_decoders.py); the
gather-free ones are kept to be timed against 'take' on the chip.

Semantics contract (must match the reference trellis layout, SURVEY.md §3.1):
a node op folds its input sequence strictly left-to-right through per-step
pairwise LUTs; output for edge j folds the sequence with element j removed,
using steps 0..d-3 in order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_FORCE_MODE: str | None = None  # 'take' | 'select' | 'packed' | None


def set_lookup_mode(mode: str | None) -> None:
    """Force the lookup lowering ('take' | 'select' | 'packed'); None = 'take'."""
    global _FORCE_MODE
    if mode not in (None, "take", "select", "packed"):
        raise ValueError(mode)
    _FORCE_MODE = mode


def _mode(vmax: int | None) -> str:
    mode = _FORCE_MODE or "take"
    if mode == "packed" and (vmax is None or vmax > 256):
        return "take"
    return mode


def _field_bits(vmax: int) -> int:
    """Field layout selector for packed columns, keyed by the LUT *value*
    bound. 4 = nibble fields (8/word); 8 = byte fields (4/word); 5 = SPLIT
    packing for 16 < vmax <= 32: the value's low nibble in fb=4 words plus
    its high bit in one fb=1 word — ceil(T0/8)+ceil(T0/32) words per column
    instead of byte-packing's ceil(T0/4), which cuts the dominant
    column-select cost ~40% for |T|=32 decoders."""
    if vmax <= 16:
        return 4
    if vmax <= 32:
        return 5
    return 8


def pairwise_lookup(
    lut: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray, vmax: int | None = None
) -> jnp.ndarray:
    """out = lut[a, b] for a 2-D LUT and equally-shaped index arrays.

    ``vmax``: static exclusive upper bound on the LUT *values* (the decoder
    passes cardinality |T|); enables the packed lowering.
    """
    mode = _mode(vmax)
    if mode == "packed":
        packed = _pack_lut(lut, _field_bits(vmax))
        cols = _select_columns(packed, b)
        return _extract(cols, a, _field_bits(vmax))
    if mode == "select":
        return _pairwise_lookup_select(lut, a, b)
    flat = lut.reshape(-1)
    return jnp.take(flat, a * lut.shape[1] + b)


def vector_lookup(
    row: jnp.ndarray, idx: jnp.ndarray, vmax: int | None = None
) -> jnp.ndarray:
    """out = row[idx] for a 1-D LUT ``row`` (matching/alignment remaps)."""
    mode = _mode(vmax)
    if mode == "packed":
        fb = _field_bits(vmax)
        words = _pack_lut(row[:, None], fb)[:, 0]  # [W] scalars
        cols = [words[w] + jnp.zeros_like(idx) for w in range(words.shape[0])]
        return _extract(cols, idx, fb)
    if mode == "select":
        out = jnp.zeros_like(idx)
        for t in range(row.shape[0]):
            out = jnp.where(idx == t, row[t], out)
        return out
    return jnp.take(row, idx)


# ---------------------------------------------------------------------------
# Packed-column machinery


def _pack_lut(lut: jnp.ndarray, field_bits: int) -> jnp.ndarray:
    """[T0, T1] int LUT -> [W, T1] int32, ``32/field_bits`` fields per word
    packed along the first (a) axis (field_bits == 5: split packing, low
    nibbles then the high-bit word — see _field_bits). Overflow into the
    sign bit wraps; the extraction mask makes that harmless."""
    if field_bits == 5:
        return jnp.concatenate(
            [_pack_lut(lut & 15, 4), _pack_lut(lut >> 4, 1)], axis=0
        )
    per = 32 // field_bits
    t0, t1 = lut.shape
    w = -(-t0 // per)
    lut = lut.astype(jnp.int32)
    if w * per != t0:
        lut = jnp.concatenate(
            [lut, jnp.zeros((w * per - t0, t1), jnp.int32)], axis=0
        )
    r = lut.reshape(w, per, t1)
    # Two's-complement wrap keeps 1 << 31 (fb=1, top bit) representable.
    weights = jnp.asarray(
        np.asarray(
            [(1 << (field_bits * k)) & 0xFFFFFFFF for k in range(per)],
            np.uint32,
        ).view(np.int32)
    )[None, :, None]
    return jnp.sum(r * weights, axis=1)


def _select_columns(packed: jnp.ndarray, b: jnp.ndarray) -> list[jnp.ndarray]:
    """Column (over b) of the packed LUT per element: W arrays like b.

    The ``b == j`` compare is computed inside the j-loop and consumed
    immediately by all W selects, so its live set is one plane, not |T1|."""
    w, t1 = packed.shape
    cols = [jnp.zeros(b.shape, jnp.int32) for _ in range(w)]
    for j in range(t1):
        bj = b == j
        for k in range(w):
            cols[k] = jnp.where(bj, packed[k, j], cols[k])
    return cols


def _extract(cols: list[jnp.ndarray], a: jnp.ndarray, field_bits: int) -> jnp.ndarray:
    """out = field ``a`` of the packed column: word select + variable shift.

    field_bits == 5 (split packing): cols[:-1] hold the value's low nibble
    (fb=4), cols[-1] its high bit (fb=1, 32 bits/word)."""
    if field_bits == 5:
        low_cols, hi = cols[:-1], cols[-1]
        if len(low_cols) == 1:
            word = low_cols[0]
        else:
            wsel = a >> 3
            word = low_cols[0]
            for k in range(1, len(low_cols)):
                word = jnp.where(wsel == k, low_cols[k], word)
        low = (word >> (4 * (a & 7))) & 15
        high = (hi >> (a & 31)) & 1
        return low | (high << 4)
    per = 32 // field_bits
    shift_bits = per.bit_length() - 1  # per is 8 or 4
    if len(cols) == 1:
        word = cols[0]
    else:
        wsel = a >> shift_bits
        word = cols[0]
        for k in range(1, len(cols)):
            word = jnp.where(wsel == k, cols[k], word)
    return (word >> (field_bits * (a & (per - 1)))) & ((1 << field_bits) - 1)


class _Stepper:
    """Chain-step evaluator with per-(LUT, message) column caching.

    ``luts``: the per-step pairwise [T0, T1] LUTs;
    ``operands``: the b-side inputs (messages / channel values).
    ``step(lut_idx, state, op_idx)`` returns luts[lut_idx][state,
    operands[op_idx]].
    """

    def __init__(self, luts: list, operands: list[jnp.ndarray], vmax: int | None):
        self.luts = luts
        self.operands = operands
        self.mode = _mode(vmax)
        if self.mode == "packed":
            self.fb = _field_bits(vmax)
            self.packed = [_pack_lut(l, self.fb) for l in luts]
            self._cols: dict[tuple[int, int], list[jnp.ndarray]] = {}

    def step(self, lut_idx: int, state: jnp.ndarray, op_idx: int) -> jnp.ndarray:
        if self.mode == "packed":
            key = (lut_idx, op_idx)
            cols = self._cols.get(key)
            if cols is None:
                cols = _select_columns(
                    self.packed[lut_idx], self.operands[op_idx]
                )
                self._cols[key] = cols
            return _extract(cols, state, self.fb)
        if self.mode == "select":
            return _pairwise_lookup_select(
                self.luts[lut_idx], state, self.operands[op_idx]
            )
        lut = self.luts[lut_idx]
        return jnp.take(
            lut.reshape(-1), state * lut.shape[1] + self.operands[op_idx]
        )


def _pairwise_lookup_select(
    lut: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """Compare-select evaluation of lut[a, b] (no gather).

    out = sum_i (a == i) * row_i, row_i = sum_j (b == j) * lut[i, j]; the
    where-chains compile to lane-wide selects and the scalar lut[i, j] reads
    (O(|T|^2) per step, vs O(nodes * batch) selects) fold into broadcasts.
    """
    t0, t1 = lut.shape
    b_is = [b == j for j in range(t1)]
    out = jnp.zeros_like(a)
    for i in range(t0):
        row = jnp.zeros_like(a)
        for j in range(t1):
            row = jnp.where(b_is[j], lut[i, j], row)
        out = jnp.where(a == i, row, out)
    return out


# ---------------------------------------------------------------------------
# Node-operation folds


def cn_lut_leave_one_out(
    msgs, step_luts: list, vmax: int | None = None
):
    """Check-node trellis update for one degree group.

    msgs: [d, n, batch] int (slot-major planes); step_luts: d-2 pairwise
    LUTs (step 0 combines the first two messages). Returns [d, n, batch]:
    output plane j = fold of all messages except j.
    """
    m = [msgs[k] for k in range(msgs.shape[0])]
    d = len(m)
    if d == 2:
        return jnp.stack([m[1], m[0]], axis=0)

    st = _Stepper(step_luts, m, vmax)
    outs: list = [None] * d
    # Full-chain prefixes f[k] = fold(m_0..m_k), k = 1..d-2.
    f: list = [None, st.step(0, m[0], 1)]
    for k in range(2, d - 1):
        f.append(st.step(k - 1, f[k - 1], k))
    # Output j >= 2 continues from prefix f[j-1] with steps j-1..d-3; the
    # step consuming message k always uses LUT k-2, so (LUT, msg) columns
    # are shared across all chains below.
    for j in range(2, d):
        s = f[j - 1]
        for k in range(j + 1, d):
            s = st.step(k - 2, s, k)
        outs[j] = s
    # Outputs 0 and 1 need their own chains (first step differs).
    s0 = st.step(0, m[1], 2)
    s1 = st.step(0, m[0], 2)
    for k in range(3, d):
        s0 = st.step(k - 2, s0, k)
        s1 = st.step(k - 2, s1, k)
    outs[0], outs[1] = s0, s1
    return jnp.stack(outs, axis=0)


def vn_lut_leave_one_out(
    ch: jnp.ndarray,
    msgs,
    first_lut,
    rest_luts: list,
    vmax: int | None = None,
):
    """Variable-node trellis update for one degree group.

    ch: [n, batch] channel clusters; msgs: [d, n, batch] incoming CN messages
    (slot-major planes). Output plane j folds (ch, all messages except j):
    first step uses ``first_lut`` (channel x message domain), later steps
    ``rest_luts`` in order (kernels_template.cl:135-166). Degree-1 nodes
    forward the channel value (kernels_template_irreg.cl:131-136). Returns
    [d, n, batch].
    """
    m = [msgs[k] for k in range(msgs.shape[0])]
    d = len(m)
    if d == 1:
        return ch[None, :, :]
    # LUT list: 0 = first (channel x msg), 1.. = rest.
    st = _Stepper([first_lut] + list(rest_luts), m, vmax)
    outs: list = [None] * d
    # Full-chain prefixes over (ch, m_0..m_k); step consuming message k (k>=1)
    # uses rest LUT k-1 (stepper index k).
    f = [st.step(0, ch, 0)]
    for k in range(1, d - 1):
        f.append(st.step(k, f[k - 1], k))
    # Chain for output j: prefix f[j-1], then steps consuming messages
    # k = j+1..d-1 with rest LUT k-2 (stepper index k-1).
    for j in range(1, d):
        s = f[j - 1]
        for k in range(j + 1, d):
            s = st.step(k - 1, s, k)
        outs[j] = s
    s0 = st.step(0, ch, 1)
    for k in range(2, d):
        s0 = st.step(k - 1, s0, k)
    outs[0] = s0
    return jnp.stack(outs, axis=0)


def vn_lut_full_fold(
    ch: jnp.ndarray,
    msgs,
    first_lut,
    rest_luts: list,
    vmax: int | None = None,
) -> jnp.ndarray:
    """Decision mapping: fold channel plus *all* d messages
    (calc_varnode_output, kernels_template.cl:241-290). msgs is
    [d, n, batch]; returns [n, batch]."""
    m = [msgs[k] for k in range(msgs.shape[0])]
    d = len(m)
    st = _Stepper([first_lut] + list(rest_luts), m, vmax)
    s = st.step(0, ch, 0)
    for k in range(1, d):
        s = st.step(k, s, k)
    return s
