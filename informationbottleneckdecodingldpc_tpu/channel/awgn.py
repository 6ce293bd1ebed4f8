"""AWGN channel with on-device PRNG.

Replaces the reference's host-numpy noise generation
(AWGN_Channel_Transmission/AWGN_channel.py:32-48) with ``jax.random`` so the
Monte-Carlo hot loop involves no host<->device traffic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def awgn_transmit(
    key: jax.Array, x: jnp.ndarray, sigma2: jnp.ndarray | float, complex_noise: bool = False
) -> jnp.ndarray:
    """y = x + n with real (or complex) Gaussian noise of variance sigma2.

    Complex symbols are I/Q pairs (trailing axis of 2, see channel.modulation): with ``complex_noise`` each
    component receives variance sigma2/2, matching the reference's complex
    channel (AWGN_channel.py:40-42).
    """
    if complex_noise:
        scale = jnp.sqrt(sigma2 / 2.0)
        return x + scale * jax.random.normal(key, x.shape, dtype=jnp.float32)
    return x + jnp.sqrt(sigma2) * jax.random.normal(key, x.shape, dtype=jnp.float32)


def sigma2_from_ebn0_db(ebn0_db, code_rate: float):
    """sigma^2 = 10^(-EbN0/10) / (2 R_c), the BPSK convention used throughout
    the reference sims (BER_simulation_OpenCL.py:85)."""
    return 10.0 ** (-ebn0_db / 10.0) / (2.0 * code_rate)


def ebn0_db_from_sigma2(sigma2, code_rate: float):
    """Inverse of :func:`sigma2_from_ebn0_db`
    (AWGN_Discrete_Density_Evolution.py:78-80)."""
    import numpy as np

    return -10.0 * np.log10(sigma2 * 2.0 * code_rate)
