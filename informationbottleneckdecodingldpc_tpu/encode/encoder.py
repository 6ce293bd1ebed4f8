"""Systematic LDPC encoder from the parity-check matrix alone.

Equivalent capability to the reference's ``LDPCEncoder``
(Discrete_LDPC_decoding/LDPC_encoder.py): split H = [A | B] with B the last
(N-K) columns, detect whether B (or its row-reversal) is triangular, otherwise
factorize B = L·U over GF(2); parity bits solve B p = A u by substitution.

Execution paths:
- host: batched, bit-packed substitution via the native C++ kernels
  (native/gf2kernels.cpp; replaces the reference's Cython ``GF2MatrixMul_c``),
  with a pure-numpy fallback;
- device: jit-compatible ``encode_device`` for accumulator (staircase)
  codes — A-multiply as gather + XOR-reduce, parity via an associative
  prefix-XOR scan — and for small B via a dense GF(2) inverse, applied as an
  integer matmul mod 2. Arbitrary B falls back to the host path.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..utils.bitpack import pack_bits, unpack_bits
from ..utils.native import load_gf2_native
from .gf2 import gf2_factorize_packed, is_full_diag_triangular, is_staircase


def _csc_arrays(X: sp.spmatrix):
    X = sp.csc_matrix(X)
    return X.indptr.astype(np.int32), X.indices.astype(np.int32)


def _np_accumulate(indptr, indices, src, dst):
    for c in range(len(indptr) - 1):
        if not src[c].any():
            continue
        for k in range(indptr[c], indptr[c + 1]):
            dst[indices[k]] ^= src[c]


def _np_substitute(indptr, indices, data, direction):
    n = len(indptr) - 1
    cols = range(n) if direction == 1 else range(n - 1, -1, -1)
    for c in cols:
        if not data[c].any():
            continue
        for k in range(indptr[c], indptr[c + 1]):
            data[indices[k]] ^= data[c]


class LDPCEncoder:
    """Encoder built once from H; ``encode`` maps [K, batch] info bits to
    [N, batch] codewords with the systematic bits first."""

    def __init__(self, H: sp.spmatrix):
        H = sp.csr_matrix(H)
        H.sum_duplicates()
        H.data[:] = 1
        self.H = H
        self.n = H.shape[1]
        self.k = self.n - H.shape[0]
        m = H.shape[0]
        if self.k <= 0:
            raise ValueError("H must have more columns than rows")
        A = sp.csc_matrix(H[:, : self.k])
        B = sp.csc_matrix(H[:, self.k :])
        self._a_indptr, self._a_indices = _csc_arrays(A)
        self.B = B
        self.is_staircase = is_staircase(B)

        shape = is_full_diag_triangular(B)
        self.row_order: np.ndarray | None = None
        self._l: tuple | None = None
        if shape == 1:
            self.method = "lower"
            P = sp.tril(B, -1)
            self._b_dir = 1
        elif shape == -1:
            self.method = "upper"
            P = sp.triu(B, 1)
            self._b_dir = -1
        else:
            rev = sp.csc_matrix(B.toarray()[::-1, :])
            rshape = is_full_diag_triangular(rev)
            if rshape != 0:
                self.method = "reversed"
                self.row_order = np.arange(m)[::-1]
                P = sp.tril(rev, -1) if rshape == 1 else sp.triu(rev, 1)
                self._b_dir = 1 if rshape == 1 else -1
            else:
                fact = gf2_factorize_packed(B)
                if not fact.invertible:
                    raise ValueError(
                        "last N-K columns of H are singular over GF(2); "
                        "permute columns or use a different code"
                    )
                self.method = "factorized"
                self.row_order = fact.row_order
                self._l = _csc_arrays(fact.l_strict)
                P = fact.u_strict_permuted
                self._b_dir = -1
        self._b_indptr, self._b_indices = _csc_arrays(P)
        self._native = load_gf2_native()

    # ------------------------------------------------------------------
    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """Host path: info_bits [K, batch] -> codewords [N, batch] int8."""
        info_bits = np.asarray(info_bits)
        if info_bits.ndim == 1:
            info_bits = info_bits[:, None]
        k, batch = info_bits.shape
        if k != self.k:
            raise ValueError(f"expected {self.k} info bits, got {k}")
        m = self.n - self.k

        packed_u, _ = pack_bits(info_bits)
        words = packed_u.shape[1]
        s = np.zeros((m, words), dtype=np.uint64)

        if self._native is not None:
            import ctypes

            i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            u64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
            ai, aj = self._a_indptr, self._a_indices
            self._native.gf2_accumulate_batch(
                self.k, i32p(ai), i32p(aj), u64p(packed_u), u64p(s), words
            )
            if self.method == "factorized":
                li, lj = self._l
                self._native.gf2_substitute_batch(m, i32p(li), i32p(lj), u64p(s), words, 1)
            if self.row_order is not None:
                s = np.ascontiguousarray(s[self.row_order])
            bi, bj = self._b_indptr, self._b_indices
            self._native.gf2_substitute_batch(m, i32p(bi), i32p(bj), u64p(s), words, self._b_dir)
        else:
            _np_accumulate(self._a_indptr, self._a_indices, packed_u, s)
            if self.method == "factorized":
                _np_substitute(self._l[0], self._l[1], s, 1)
            if self.row_order is not None:
                s = np.ascontiguousarray(s[self.row_order])
            _np_substitute(self._b_indptr, self._b_indices, s, self._b_dir)

        parity = unpack_bits(s, batch)
        return np.concatenate([info_bits.astype(np.int8), parity], axis=0)

    # ------------------------------------------------------------------
    def device_encoder(self):
        """Return a jit-compatible encode function, or None if B needs the
        host path. The returned fn maps [K, batch] int -> [N, batch] int8."""
        import jax
        import jax.numpy as jnp

        m = self.n - self.k
        A = sp.csr_matrix(self.H[:, : self.k])
        row_deg = np.diff(A.indptr)
        max_deg = int(row_deg.max()) if m else 0
        # Pad each parity row's info-column list with index K (a zero row).
        cols = np.full((m, max_deg), self.k, dtype=np.int32)
        for r in range(m):
            c = A.indices[A.indptr[r] : A.indptr[r + 1]]
            cols[r, : c.size] = c
        cols = jnp.asarray(cols)

        if self.is_staircase:
            def encode_device(u):
                u = u.astype(jnp.int32)
                u_pad = jnp.concatenate(
                    [u, jnp.zeros((1,) + u.shape[1:], jnp.int32)], axis=0
                )
                s = jnp.bitwise_xor.reduce(u_pad[cols], axis=1)
                parity = jax.lax.associative_scan(jnp.bitwise_xor, s, axis=0)
                return jnp.concatenate([u, parity], axis=0).astype(jnp.int8)

            return encode_device

        if m <= 4096:
            # Dense GF(2) inverse of B once on host, then an integer matmul.
            Bd = self.B.toarray().astype(np.uint8)
            inv = _gf2_dense_inverse(Bd)
            if inv is None:
                return None
            binv = jnp.asarray(inv.astype(np.int8))

            def encode_device(u):
                u = u.astype(jnp.int32)
                u_pad = jnp.concatenate(
                    [u, jnp.zeros((1,) + u.shape[1:], jnp.int32)], axis=0
                )
                s = jnp.bitwise_xor.reduce(u_pad[cols], axis=1)
                parity = (
                    jnp.matmul(
                        binv.astype(jnp.int32), s, preferred_element_type=jnp.int32
                    )
                    % 2
                )
                return jnp.concatenate([u, parity], axis=0).astype(jnp.int8)

            return encode_device
        return None

    # ------------------------------------------------------------------
    def check(self, codewords: np.ndarray) -> np.ndarray:
        """Syndrome H c over GF(2): [n_checks, batch] (0 = valid)."""
        cw = np.asarray(codewords)
        if cw.ndim == 1:
            cw = cw[:, None]
        packed, batch = pack_bits(cw)
        m = self.H.shape[0]
        out = np.zeros((m, packed.shape[1]), dtype=np.uint64)
        if self._native is not None:
            import ctypes

            i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            u64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
            hi = self.H.indptr.astype(np.int32)
            hj = self.H.indices.astype(np.int32)
            self._native.gf2_syndrome_batch(
                m, i32p(hi), i32p(hj), u64p(packed), u64p(out), packed.shape[1]
            )
        else:
            for r in range(m):
                for c in self.H.indices[self.H.indptr[r] : self.H.indptr[r + 1]]:
                    out[r] ^= packed[c]
        return unpack_bits(out, batch)


def _gf2_dense_inverse(B: np.ndarray) -> np.ndarray | None:
    """Dense GF(2) inverse by Gauss-Jordan; None if singular."""
    m = B.shape[0]
    work = B.astype(np.uint8).copy()
    inv = np.eye(m, dtype=np.uint8)
    for col in range(m):
        pivots = np.nonzero(work[col:, col])[0]
        if pivots.size == 0:
            return None
        p = col + int(pivots[0])
        if p != col:
            work[[col, p]] = work[[p, col]]
            inv[[col, p]] = inv[[p, col]]
        rows = np.nonzero(work[:, col])[0]
        rows = rows[rows != col]
        if rows.size:
            work[rows] ^= work[col]
            inv[rows] ^= inv[col]
    return inv
