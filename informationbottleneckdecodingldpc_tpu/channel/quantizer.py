"""Information-optimum AWGN channel-output quantizer for BPSK.

JAX counterpart of the reference's ``AWGN_Channel_Quantizer``
(AWGN_Channel_Transmission/AWGN_Quantizer_BPSK.py): the quantizer tables are
constructed once on the host (fine grid + exact DP symmetric IB instead of
randomized sIB), then all hot-loop operations — threshold quantization, direct
cluster sampling via the inversion method, and LLR emission — are pure jnp
functions over those tables, with `jax.random` device PRNG replacing the
reference's host ``np.random`` (AWGN_Quantizer_BPSK.py:210,234).

The pure functions (`quantize_with`, `sample_clusters_with`, ...) take the
tables as runtime arguments, so one compilation of a simulation step serves
every SNR point of a sweep; the class below binds tables for convenience.

Conventions preserved exactly (they are contracts with the decoders):
- bit 0 maps to +1 (quantizer built on p(y|x=0) = N(+1, sigma^2));
- cluster labels ascend with y (and with LLR); ``limits[T/2]`` forced to 0
  (AWGN_Quantizer_BPSK.py:116-124);
- direct sampling draws t ~ p(t|x=0) by inversion and mirrors t -> T-1-t for
  transmitted bit 1 (AWGN_Quantizer_BPSK.py:126-143);
- ``output_LLRs[t] = ln p(x=0,t) - ln p(x=1,t)`` (AWGN_Quantizer_BPSK.py:96).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import norm

from ..ib import optimal_symmetric_quantizer


@dataclasses.dataclass(frozen=True)
class QuantizerTables:
    """Static arrays driving the on-device quantizer ops."""

    sigma2: float
    ad_max_abs: float
    cardinality_t: int
    cardinality_y: int
    limits: np.ndarray  # [T] region lower borders in y-domain
    cdf_t_given_x0: np.ndarray  # [T+1] inversion-sampling cdf
    output_llrs: np.ndarray  # [T] natural-log LLR per cluster
    p_x_and_t: np.ndarray  # [T, 2] joint pmf (DE input)
    mi_xt: float
    mi_xy: float


class DeviceQuantizerTables(NamedTuple):
    """Runtime-argument form for jitted simulation steps (one compile per
    sweep; tables swap per SNR point)."""

    limits: jnp.ndarray  # [T] float32
    cdf: jnp.ndarray  # [T+1] float32
    llrs: jnp.ndarray  # [T] float32


def build_quantizer_tables(
    sigma2: float,
    ad_max_abs: float = 3.0,
    cardinality_t: int = 16,
    cardinality_y: int = 2000,
) -> QuantizerTables:
    """Host-side construction of the quantizer (grid pmf + DP-IB clustering)."""
    y_vec = np.linspace(-ad_max_abs, ad_max_abs, cardinality_y)
    delta = y_vec[1] - y_vec[0]
    sigma = np.sqrt(sigma2)

    # p(y | x=0): Gaussian at +1, with the clipped tail mass folded into the
    # border cells exactly as the reference does
    # (AWGN_Quantizer_BPSK.py:67-78,104-114).
    p0 = norm.pdf(y_vec, loc=1.0, scale=sigma) * delta
    p0[-1] += norm.sf((ad_max_abs - 1.0 + delta / 2) / sigma)
    p0[0] += 1.0 - norm.sf((-ad_max_abs - delta - 1.0 + delta / 2) / sigma)
    p1 = p0[::-1]
    p_xy = 0.5 * np.stack([p0, p1], axis=1)
    p_xy = p_xy / p_xy.sum()

    r = optimal_symmetric_quantizer(p_xy, cardinality_t)

    p_x_given_t = r.p_x_given_t / r.p_x_given_t.sum(axis=1, keepdims=True)
    p_x_and_t = p_x_given_t * r.p_t[:, None]
    p_t_given_x0 = p_x_and_t[:, 0] / 0.5
    cdf = np.concatenate([[0.0], np.cumsum(p_t_given_x0)])
    cdf[-1] = max(cdf[-1], 1.0)  # guard against rounding so u<1 always lands
    with np.errstate(divide="ignore"):
        output_llrs = np.log(p_x_and_t[:, 0]) - np.log(p_x_and_t[:, 1])

    # Region borders: first grid point of each cluster; middle border at 0.
    limits = np.empty(cardinality_t)
    for t in range(cardinality_t):
        limits[t] = y_vec[np.nonzero(r.labels == t)[0].min()]
    limits[cardinality_t // 2] = 0.0

    return QuantizerTables(
        sigma2=float(sigma2),
        ad_max_abs=float(ad_max_abs),
        cardinality_t=int(cardinality_t),
        cardinality_y=int(cardinality_y),
        limits=limits,
        cdf_t_given_x0=cdf,
        output_llrs=output_llrs,
        p_x_and_t=p_x_and_t,
        mi_xt=r.mi_xt,
        mi_xy=r.mi_xy,
    )


def device_tables(tables: QuantizerTables) -> DeviceQuantizerTables:
    return DeviceQuantizerTables(
        limits=jnp.asarray(tables.limits, dtype=jnp.float32),
        cdf=jnp.asarray(tables.cdf_t_given_x0, dtype=jnp.float32),
        llrs=jnp.asarray(tables.output_llrs, dtype=jnp.float32),
    )


# ---------------------------------------------------------------------------
# Pure device ops (tables as runtime arguments).
# ---------------------------------------------------------------------------

def _threshold_count(thresholds: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """#{w : x > thresholds[w]} as an accumulated compare loop (elementwise
    ops on whole planes; avoids materializing an [.., T] broadcast)."""
    t = jnp.zeros(x.shape, jnp.int32)
    for w in range(thresholds.shape[0]):
        t = t + (x > thresholds[w]).astype(jnp.int32)
    return t


def _float_table_select(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """out = table[idx] for a small float table, as a compare-select chain."""
    out = jnp.full(idx.shape, table[0], dtype=table.dtype)
    for t in range(1, table.shape[0]):
        out = jnp.where(idx == t, table[t], out)
    return out


def quantize_with(limits: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """cluster = #{w in 1..T-1 : y > limits[w]} (kernel semantics,
    kernels_quanti_template.cl:17-23)."""
    return _threshold_count(limits[1:], y)


def quantize_llr_with(
    limits: jnp.ndarray, llrs: jnp.ndarray, y: jnp.ndarray
) -> jnp.ndarray:
    """LLR of the quantized cluster (kernels_quanti_template.cl:29-49)."""
    return _float_table_select(llrs, quantize_with(limits, y))


def sample_clusters_from_uniform(
    cdf: jnp.ndarray, u: jnp.ndarray, bits: jnp.ndarray
) -> jnp.ndarray:
    """Inversion sampling t ~ p(t | x=bit) from pre-drawn uniforms, mirroring
    for bit 1 (quantize_direct, AWGN_Quantizer_BPSK.py:126-143). Taking ``u``
    as an argument lets callers derive it from per-codeword RNG keys so Monte
    Carlo counters are independent of batch sharding."""
    cardinality_t = cdf.shape[0] - 1
    t = _threshold_count(cdf[1:-1], u)
    return jnp.where(bits.astype(bool), cardinality_t - 1 - t, t)


def sample_clusters_with(
    cdf: jnp.ndarray, key: jax.Array, bits: jnp.ndarray
) -> jnp.ndarray:
    """Draw t ~ p(t | x=bit) by inversion, mirroring for bit 1
    (quantize_direct, AWGN_Quantizer_BPSK.py:126-143)."""
    u = jax.random.uniform(key, bits.shape, dtype=jnp.float32)
    return sample_clusters_from_uniform(cdf, u, bits)


def sample_llrs_from_uniform(
    cdf: jnp.ndarray, llrs: jnp.ndarray, u: jnp.ndarray, bits: jnp.ndarray
) -> jnp.ndarray:
    """LLR of inversion-sampled clusters from pre-drawn uniforms."""
    return _float_table_select(llrs, sample_clusters_from_uniform(cdf, u, bits))


def sample_llrs_with(
    cdf: jnp.ndarray, llrs: jnp.ndarray, key: jax.Array, bits: jnp.ndarray
) -> jnp.ndarray:
    """LLR of directly sampled clusters (quantize_direct_OpenCL_LLR,
    AWGN_Quantizer_BPSK.py:230-248)."""
    return _float_table_select(llrs, sample_clusters_with(cdf, key, bits))


class AWGNChannelQuantizer:
    """Quantizer with device ops bound to precomputed tables."""

    def __init__(
        self,
        sigma2: float,
        ad_max_abs: float = 3.0,
        cardinality_t: int = 16,
        cardinality_y: int = 2000,
    ):
        self.tables = build_quantizer_tables(
            sigma2, ad_max_abs, cardinality_t, cardinality_y
        )
        self.cardinality_t = self.tables.cardinality_t
        self.device = device_tables(self.tables)

    def quantize(self, y: jnp.ndarray) -> jnp.ndarray:
        return quantize_with(self.device.limits, y)

    def quantize_llr(self, y: jnp.ndarray) -> jnp.ndarray:
        return quantize_llr_with(self.device.limits, self.device.llrs, y)

    def sample_clusters(self, key: jax.Array, bits: jnp.ndarray) -> jnp.ndarray:
        return sample_clusters_with(self.device.cdf, key, bits)

    def sample_llrs(self, key: jax.Array, bits: jnp.ndarray) -> jnp.ndarray:
        return sample_llrs_with(self.device.cdf, self.device.llrs, key, bits)
