"""Structured-layout data-movement plans: strided runs, block transposes,
edge-key slot ordering. These are what make the q-group (DVB-S2) routing
gather-free (decode/graph_arrays.py)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from informationbottleneckdecodingldpc_tpu.codes import (
    TannerGraph,
    dvbs2_layout_edge_keys,
    dvbs2_layout_node_keys,
    dvbs2_like_parity_check,
)
from informationbottleneckdecodingldpc_tpu.decode import DecodeLayout
from informationbottleneckdecodingldpc_tpu.decode.graph_arrays import PermutationPlan
from informationbottleneckdecodingldpc_tpu.decode.min_sum import min_sum_decode


def _check(perm, rng, force_runs=False):
    p = PermutationPlan.from_permutation(perm)
    if force_runs:
        p = dataclasses.replace(p, use_runs=True)
    x = jnp.asarray(rng.integers(0, 100, (int(perm.max()) + 1, 2)))
    got = np.asarray(p.apply(x))
    np.testing.assert_array_equal(got, np.asarray(x)[perm])
    return p


def test_plan_block_transpose_detection():
    rng = np.random.default_rng(0)
    perm = (np.arange(36 * 9).reshape(36, 9).T).ravel()
    p = _check(perm, rng)
    assert p.num_transposes == 1 and p.num_runs == 0
    # truncated block (DVB-S2's lone degree-1 parity node)
    p = _check(perm[:-1], rng)
    assert p.num_transposes == 1
    # contiguous prefix flowing into a transpose (rebalance path)
    p = _check(np.concatenate([np.arange(100), 100 + perm]), rng)
    assert p.num_transposes == 1 and p.num_runs == 1


def test_plan_fuzz_structured_mixtures():
    rng = np.random.default_rng(7)
    for _ in range(25):
        pieces, off = [], 0
        for _ in range(rng.integers(1, 5)):
            kind = rng.integers(0, 3)
            if kind == 0:
                L = int(rng.integers(1, 40))
                pieces.append(off + np.arange(L))
                off += L
            elif kind == 1:
                A, B = int(rng.integers(2, 8)), int(rng.integers(2, 8))
                blk = off + (np.arange(A * B).reshape(A, B).T).ravel()
                if rng.integers(0, 2):
                    blk = blk[: max(1, int(rng.integers(1, A * B)))]
                pieces.append(blk)
                off += A * B
            else:
                L, s = int(rng.integers(2, 16)), int(rng.integers(2, 5))
                pieces.append(off + np.arange(L) * s)
                off += L * s
        _check(np.concatenate(pieces), rng, force_runs=True)
    for _ in range(10):
        perm = rng.permutation(int(rng.integers(5, 150)))
        _check(perm, rng)
        _check(perm, rng, force_runs=True)


@pytest.fixture(scope="module")
def ira_layouts():
    H = dvbs2_like_parity_check(1920, 960, seed=9)
    g = TannerGraph.from_check_matrix(H)
    plain = DecodeLayout.from_graph(g)
    ck, vk = dvbs2_layout_node_keys(1920, 960)
    ek_csr, ek_csc = dvbs2_layout_edge_keys(H, 960)
    structured = DecodeLayout.from_graph(
        g, cn_node_key=ck, vn_node_key=vk, cn_edge_key=ek_csr, vn_edge_key=ek_csc
    )
    return plain, structured


def test_structured_layout_plans_are_gather_free(ira_layouts):
    _, structured = ira_layouts
    for nm in ("to_vn", "to_cn", "seed_plan", "vn_gather_plan", "vn_unperm_plan"):
        p = getattr(structured, nm)
        assert p.use_runs, f"{nm} fell back to a row gather"


def test_structured_layout_minsum_bit_exact(ira_layouts):
    """Min-sum node ops are commutative, so any two slot orderings of the
    same graph must produce bitwise-identical decodes — a strong end-to-end
    check of the run/transpose routing."""
    plain, structured = ira_layouts
    rng = np.random.default_rng(3)
    # Integer-valued LLRs: min-sum stays exact integer arithmetic, so the
    # decode is bitwise order-independent (float-noise inputs would differ
    # by summation order).
    llrs = jnp.asarray(
        rng.integers(-7, 8, (1920, 4)).astype(np.float32)
    )
    r1 = min_sum_decode(plain, llrs, max_iters=8, early_exit=False)
    r2 = min_sum_decode(structured, llrs, max_iters=8, early_exit=False)
    np.testing.assert_array_equal(np.asarray(r1.outputs), np.asarray(r2.outputs))
    np.testing.assert_array_equal(
        np.asarray(r1.unsatisfied), np.asarray(r2.unsatisfied)
    )
