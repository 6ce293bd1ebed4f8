import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from informationbottleneckdecodingldpc_tpu.codes import (
    TannerGraph,
    dvbs2_layout_edge_keys,
    dvbs2_layout_node_keys,
    dvbs2_like_parity_check,
    regular_parity_check,
    regular_qc_parity_check,
    wlan_80211n_parity_check,
)
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config
from informationbottleneckdecodingldpc_tpu.construct.trellis import TrellisTables
from informationbottleneckdecodingldpc_tpu.decode import (
    DecodeLayout,
    belief_propagation_decode,
    ib_lut_decode,
    min_sum_decode,
)
from informationbottleneckdecodingldpc_tpu.decode.ib_lut import DeviceTrellis

from reference_impls import brute_float_decode, brute_lut_decode


def small_irregular_H(rng, n_c=12, n_v=24):
    """Random irregular H with degrees >= 2 everywhere."""
    while True:
        H = (rng.random((n_c, n_v)) < 0.18).astype(np.int8)
        # ensure min degrees
        for v in range(n_v):
            while H[:, v].sum() < 2:
                H[rng.integers(n_c), v] = 1
        for c in range(n_c):
            while H[c].sum() < 3:
                H[c, rng.integers(n_v)] = 1
        if H.sum(0).max() <= 8 and H.sum(1).max() <= 10:
            return H


def random_trellis_tables(rng, t_ch, t_dec, i_max, d_c_max, d_v_max, matching=False):
    """Random (but valid-shaped) LUTs — enough to test decoder plumbing."""
    mk = lambda *shape: rng.integers(0, t_dec, size=shape).astype(np.int64)
    return TrellisTables(
        cardinality_t_channel=t_ch,
        cardinality_t_decoder=t_dec,
        i_max=i_max,
        d_c_max=d_c_max,
        d_v_max=d_v_max,
        cn_iter0_first=mk(t_ch, t_ch),
        cn_iter0_rest=mk(max(d_c_max - 3, 0), t_dec, t_ch),
        cn_rest=mk(i_max - 1, d_c_max - 2, t_dec, t_dec),
        vn_first=mk(i_max, t_ch, t_dec),
        vn_rest=mk(i_max, d_v_max - 1, t_dec, t_dec),
        matching_cn=mk(i_max, d_c_max, t_dec) if matching else None,
        matching_vn=mk(i_max, d_v_max, t_dec) if matching else None,
    )


# ---------------------------------------------------------------------------
# XLA decoders against the brute-force references (tests/reference_impls.py)
# on small random codes and on structured codes: a quasi-cyclic regular (3,6)
# code and a DVB-S2-like IRA code in its run-decomposed layout.

_LAYOUTS: dict = {}


def _layout(name, rng):
    """(dense H, DecodeLayout) for a named test code; structured codes are
    built once per module."""
    if name == "small_irregular":
        H = small_irregular_H(rng)
        return H, DecodeLayout.from_graph(
            TannerGraph.from_check_matrix(sp.csr_matrix(H))
        )
    if name == "regular24":
        H = regular_parity_check(24, 3, 6, seed=3)
        return H.toarray(), DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
    if name not in _LAYOUTS:
        if name == "qc_regular":
            H = regular_qc_parity_check(96, 3, 6, seed=7)
            layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
        elif name == "qc_regular_s11":
            H = regular_qc_parity_check(96, 3, 6, seed=11)
            layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
        elif name in ("ira", "ira_slot_keys"):
            # Node keys make the routing run-decomposed; slot keys also
            # reorder each node's inbox, which changes the order of the IB
            # LUT folds (so only the float decoders, whose folds commute up
            # to rounding, are compared with the natural-order reference).
            H = dvbs2_like_parity_check(1920, 960, seed=9)
            ck, vk = dvbs2_layout_node_keys(1920, 960)
            kw = dict(cn_node_key=ck, vn_node_key=vk)
            if name == "ira_slot_keys":
                kw["cn_edge_key"], kw["vn_edge_key"] = dvbs2_layout_edge_keys(H, 960)
            layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H), **kw)
        else:
            raise KeyError(name)
        _LAYOUTS[name] = (H.toarray(), layout)
    return _LAYOUTS[name]


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed", "early_exit"])
@pytest.mark.parametrize(
    "code", ["small_irregular", "qc_regular", "ira", "ira_slot_keys"]
)
@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_float_decoder_matches_bruteforce(rng, rule, code, early_exit):
    H, layout = _layout(code, rng)
    batch = 3
    max_iters = 6 if code.startswith("ira") else 5
    # Early exit: low noise, so the whole batch converges before max_iters.
    mean, std = (2.5, 1.0) if early_exit else (0.7, 2.0)
    llrs = rng.normal(mean, std, size=(H.shape[1], batch)).astype(np.float32)

    fn = min_sum_decode if rule == "minsum" else belief_propagation_decode
    res = fn(layout, jnp.asarray(llrs), max_iters=max_iters, early_exit=early_exit)
    out = np.asarray(res.outputs)
    iters = int(res.iterations)
    if not early_exit:
        assert iters == max_iters - 1
    # The framework's early exit is batch-global: rerun the per-codeword
    # reference with the framework's iteration count.
    for b in range(batch):
        brute, brute_iters, brute_unsat = brute_float_decode(
            H, llrs[:, b].astype(np.float64), max_iters=iters + 1, rule=rule,
            early_exit=False,
        )
        assert brute_iters == iters
        # float32 device path vs float64 brute force: small drift per iteration
        np.testing.assert_allclose(out[:, b], brute, rtol=3e-3, atol=3e-3)
        assert int(res.unsatisfied[b]) == brute_unsat


def test_float_decoder_early_exit_iterations(rng):
    # All-zero codeword with strong LLRs decodes immediately.
    H = regular_parity_check(48, 3, 6, seed=1)
    layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
    llrs = jnp.full((48, 2), 7.0, dtype=jnp.float32)
    res = min_sum_decode(layout, llrs, max_iters=30, early_exit=True)
    assert int(res.iterations) == 1
    assert np.all(np.asarray(res.unsatisfied) == 0)
    assert np.all(np.asarray(res.outputs) > 0)


_CONFIGS: dict = {}


def _config_tables(name, H):
    """Constructed decoder tables (discrete DE) for the structured codes."""
    if name not in _CONFIGS:
        if name == "ira":
            kw = dict(design_ebn0_db=1.5, cardinality_t_channel=16,
                      cardinality_t_decoder=16, i_max=5, H=sp.csr_matrix(H))
        elif name == "qc_regular":
            kw = dict(design_ebn0_db=2.0, cardinality_t_channel=16,
                      cardinality_t_decoder=16, i_max=6, d_v=3, d_c=6)
        else:  # |T|=32 on the seed-11 QC code
            kw = dict(design_ebn0_db=2.0, cardinality_t_channel=32,
                      cardinality_t_decoder=32, i_max=4, d_v=3, d_c=6)
        _CONFIGS[name] = build_decoder_config(cardinality_y_channel=400, **kw).tables
    return _CONFIGS[name]


# (code, tables): random tables exercise the plumbing on arbitrary degree
# profiles (with and without message alignment); constructed tables make the
# early exit fire on structured codes, including |T|=32.
_LUT_CASES = {
    "small_irregular-random": ("small_irregular", False),
    "small_irregular-random_matching": ("small_irregular", True),
    "regular24-random": ("regular24", False),
    "qc_regular-T16": ("qc_regular", "qc_regular"),
    "qc_regular-T32": ("qc_regular_s11", "qc_regular_T32"),
    "ira-T16": ("ira", "ira"),
}


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed", "early_exit"])
@pytest.mark.parametrize("case", list(_LUT_CASES))
def test_lut_decoder_matches_bruteforce(rng, case, early_exit):
    code, tables_kind = _LUT_CASES[case]
    H, layout = _layout(code, rng)
    if isinstance(tables_kind, bool):
        tables = random_trellis_tables(
            rng, 8, 8, 4, layout.d_c_max, layout.d_v_max, matching=tables_kind
        )
    else:
        tables = _config_tables(tables_kind, H)
    t = tables.cardinality_t_decoder
    i_max = tables.i_max
    trellis = DeviceTrellis.from_tables(tables)
    batch = 3
    # Clusters t >= T/2 decode bit 0; early exit draws a mostly-correct
    # all-zeros word so constructed decoders converge before i_max.
    low = t // 2 - 2 if early_exit else 0
    channel = rng.integers(low, tables.cardinality_t_channel, size=(H.shape[1], batch))

    res = ib_lut_decode(
        layout, trellis, jnp.asarray(channel), max_iters=i_max,
        early_exit=early_exit,
    )
    out = np.asarray(res.outputs)
    iters = int(res.iterations)
    if not early_exit:
        assert iters == i_max - 1
    # The framework's early exit is batch-global: rerun the per-codeword
    # reference with the framework's iteration count.
    for b in range(batch):
        brute, brute_iters, brute_unsat = brute_lut_decode(
            H, tables, channel[:, b], max_iters=iters + 1,
            use_matching=tables.has_matching, early_exit=False,
        )
        assert brute_iters == iters
        np.testing.assert_array_equal(out[:, b], brute)
        assert int(res.unsatisfied[b]) == brute_unsat


def test_wlan_layout_builds():
    g = TannerGraph.from_check_matrix(wlan_80211n_parity_check())
    layout = DecodeLayout.from_graph(g)
    assert layout.n_edges == g.n_edges
    assert layout.data_len == 648
    degrees = sorted(grp.degree for grp in layout.vn_groups)
    assert degrees == [2, 3, 4, 11]


def test_pairwise_lookup_select_matches_take(rng):
    """The compare-select and packed lowerings are bit-exact vs the gather
    lowering."""
    from informationbottleneckdecodingldpc_tpu.ops import lut_fold

    for t0, t1 in [(16, 16), (32, 16), (16, 32), (5, 7)]:
        lut = jnp.asarray(rng.integers(0, 31, size=(t0, t1)), jnp.int32)
        a = jnp.asarray(rng.integers(0, t0, size=(33, 17)), jnp.int32)
        b = jnp.asarray(rng.integers(0, t1, size=(33, 17)), jnp.int32)
        want = np.asarray(lut)[np.asarray(a), np.asarray(b)]
        vmax = int(np.asarray(lut).max()) + 1
        try:
            for mode in ("select", "take", "packed"):
                lut_fold.set_lookup_mode(mode)
                got = lut_fold.pairwise_lookup(lut, a, b, vmax=vmax)
                np.testing.assert_array_equal(np.asarray(got), want, err_msg=mode)
                row = lut[0]
                got_row = lut_fold.vector_lookup(row, b, vmax=vmax)
                np.testing.assert_array_equal(
                    np.asarray(got_row), np.asarray(row)[np.asarray(b)], err_msg=mode
                )
        finally:
            lut_fold.set_lookup_mode(None)


def test_lut_decoder_select_mode_matches_take_mode(rng):
    """Full decode is bit-exact under either lookup lowering."""
    from informationbottleneckdecodingldpc_tpu.ops import lut_fold

    H = small_irregular_H(rng)
    g = TannerGraph.from_check_matrix(H)
    layout = DecodeLayout.from_graph(g)
    tables = random_trellis_tables(
        rng, 16, 16, 4, g.d_c_max, g.d_v_max, matching=True
    )
    trellis = DeviceTrellis.from_tables(tables)
    ch = jnp.asarray(rng.integers(0, 16, size=(g.n_vars, 3)), jnp.int32)
    outs = {}
    try:
        for mode in ("select", "take", "packed"):
            lut_fold.set_lookup_mode(mode)
            outs[mode] = np.asarray(
                ib_lut_decode(layout, trellis, ch, early_exit=False).outputs
            )
    finally:
        lut_fold.set_lookup_mode(None)
    np.testing.assert_array_equal(outs["select"], outs["take"])
    np.testing.assert_array_equal(outs["packed"], outs["take"])


def test_take_is_the_default_lookup_lowering(rng):
    """With no mode forced, every lookup is one gather on every backend."""
    import jax

    from informationbottleneckdecodingldpc_tpu.ops import lut_fold

    assert lut_fold._FORCE_MODE is None
    assert lut_fold._mode(16) == lut_fold._mode(None) == "take"
    lut = jnp.asarray(rng.integers(0, 16, size=(16, 16)), jnp.int32)
    idx = jnp.asarray(rng.integers(0, 16, size=(4, 8)), jnp.int32)
    jaxpr = jax.make_jaxpr(
        lambda l, a, b: lut_fold.pairwise_lookup(l, a, b, vmax=16)
    )(lut, idx, idx)
    text = str(jaxpr)
    # One gather, and none of the compare-select trees of the other modes.
    assert text.count("gather[") == 1 and " eq " not in text


def test_minsum_min1min2_matches_pairwise_on_edge_cases(rng):
    # Ties on the minimum magnitude and exact zeros: the min1/min2 +
    # sign-product fold must match the pairwise min_sum_op prefix/suffix
    # fold (values identical; zero sign may differ, compare with ==).
    from informationbottleneckdecodingldpc_tpu.ops.float_ops import (
        associative_leave_one_out,
        min_sum_op,
        minsum_leave_one_out_planes,
    )

    cases = [
        [1.5, -1.5, 2.0, 1.5, -3.0],     # triple tie at the min
        [0.0, 2.0, -1.0, 4.0],           # one zero
        [0.0, -0.0, 3.0],                # two zeros
        [-2.0, -2.0, -2.0, -2.0],        # all equal, all negative
        [5.0, -1.0],                     # degree 2
    ]
    for vals in cases:
        planes = [jnp.full((4, 8), v, jnp.float32) for v in vals]
        got = minsum_leave_one_out_planes(planes)
        ref = associative_leave_one_out(
            min_sum_op, jnp.stack(planes, axis=0)
        )
        for j in range(len(vals)):
            assert np.all(np.asarray(got[j]) == np.asarray(ref[j])), (
                vals, j, np.asarray(got[j])[0, 0], np.asarray(ref[j])[0, 0]
            )
