"""Modulation mappings and transmitters (BPSK, square QAM, MPSK).

JAX equivalents of the reference transmitters
(AWGN_Channel_Transmission/LDPC_Transmitter.py:14-215 encoded,
AWGN_Channel_Transmission/Transmitter.py:14-118 uncoded): the bit->symbol
maps are pure jittable functions over ``[n_bits, batch]`` arrays, and the
transmitter classes compose them with on-device bit generation and the
batched GF(2) encoder (no per-codeword host loop).

BPSK is the primary chain (the reference's QAM/MPSK *construction* paths are
dead upstream — ``AWGN_Quantizer_Mary`` is absent, SURVEY.md §7.4 — so only
BPSK feeds the IB quantizer/DE pipeline), but the QAM/MPSK symbol mappings
themselves are reproduced for parity of the transmit side:

- QAM (LDPC_Transmitter.py:160-175): consecutive groups of
  ``2*log2(sqrt_M)`` bits per symbol, first half -> real PAM level, second
  half -> imaginary, MSB first; an ``encoding_table`` (rows of bit patterns
  in amplitude order, typically Gray) assigns levels ``-sqrt_M+1 .. sqrt_M-1``
  step 2, scaled by ``d_min/2 = sqrt(6/(sqrt_M^2-1))/2`` (unit average
  energy for uniform bits).
- MPSK (LDPC_Transmitter.py:203-215): groups of ``log2(M)`` bits, MSB first,
  mapped through the encoding table to phases ``exp(2j*pi*k/M)``.

Complex symbols are represented as I/Q pairs — float32 arrays with a trailing
dimension of 2 ([n_symbols, batch, 2]). ``iq_to_complex`` converts on host.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def bpsk_map(bits: jnp.ndarray) -> jnp.ndarray:
    """Map bits to BPSK symbols: 0 -> +1, 1 -> -1.

    Same convention as the reference transmitter
    (AWGN_Channel_Transmission/LDPC_Transmitter.py:127-132).
    """
    return 1.0 - 2.0 * bits.astype(jnp.float32)


def gray_encoding_table(num_bits: int) -> np.ndarray:
    """[2**num_bits, num_bits] bit patterns in Gray-code order.

    Row k is the bit pattern assigned to the k-th amplitude/phase — the
    conventional choice for the reference's ``encoding_table`` arguments
    (LDPC_Transmitter.py:136,178).
    """
    n = 1 << num_bits
    codes = np.arange(n) ^ (np.arange(n) >> 1)
    return (
        (codes[:, None] >> np.arange(num_bits - 1, -1, -1)) & 1
    ).astype(np.int8)


def _natural_values(encoding_table: np.ndarray) -> np.ndarray:
    """MSB-first integer value of each table row
    (LDPC_Transmitter.py:173,211)."""
    table = np.asarray(encoding_table)
    k = table.shape[1]
    return (table * (1 << np.arange(k - 1, -1, -1))).sum(1).astype(np.int64)


def qam_tables(encoding_table: np.ndarray, sqrt_m: int) -> tuple[np.ndarray, float]:
    """(amplitude_values[sqrt_m], d_min) per LDPC_Transmitter.py:171-175."""
    amplitudes = np.zeros(sqrt_m)
    amplitudes[_natural_values(encoding_table)] = np.arange(
        -sqrt_m + 1, sqrt_m, 2
    )
    d_min = float(np.sqrt(6.0 / (sqrt_m**2 - 1)))
    return amplitudes, d_min


def mpsk_tables(encoding_table: np.ndarray, m: int) -> np.ndarray:
    """phase_values[m] complex unit symbols per LDPC_Transmitter.py:213-215."""
    phases = np.zeros(m, dtype=np.complex128)
    phases[_natural_values(encoding_table)] = np.exp(
        2j * np.pi / m * np.arange(m)
    )
    return phases


def _bit_group_values(bits: jnp.ndarray, k: int) -> jnp.ndarray:
    """[n, batch] bits -> [n//k, batch] MSB-first integer group values.

    Groups are consecutive bits along the codeword, per message column
    (the reference's reshape of X.T, LDPC_Transmitter.py:162-169).
    """
    n, batch = bits.shape
    if n % k:
        raise ValueError(f"bit length {n} not divisible by group size {k}")
    groups = bits.astype(jnp.int32).T.reshape(batch, n // k, k)
    weights = jnp.asarray(1 << np.arange(k - 1, -1, -1), jnp.int32)
    return jnp.tensordot(groups, weights, axes=([2], [0])).T


def qam_map(
    bits: jnp.ndarray, encoding_table: np.ndarray, sqrt_m: int
) -> jnp.ndarray:
    """Map [n, batch] bits to [n/(2 log2 sqrt_m), batch, 2] I/Q QAM symbols."""
    k_half = int(np.log2(sqrt_m))
    amplitudes, d_min = qam_tables(encoding_table, sqrt_m)
    amp = jnp.asarray(amplitudes, jnp.float32)
    vals = _bit_group_values(bits, 2 * k_half)  # [n_sym, batch]
    re = jnp.take(amp, vals >> k_half)
    im = jnp.take(amp, vals & (sqrt_m - 1))
    return jnp.stack([re, im], axis=-1) * (d_min / 2.0)


def mpsk_map(bits: jnp.ndarray, encoding_table: np.ndarray, m: int) -> jnp.ndarray:
    """Map [n, batch] bits to [n/log2(m), batch, 2] I/Q unit-energy MPSK
    symbols."""
    k = int(np.log2(m))
    phases = mpsk_tables(encoding_table, m)
    vals = _bit_group_values(bits, k)
    table = jnp.asarray(
        np.stack([phases.real, phases.imag], axis=-1), jnp.float32
    )
    return jnp.take(table, vals, axis=0)


def iq_to_complex(x: jnp.ndarray) -> np.ndarray:
    """Host-side view of an I/Q pair array as complex (last axis of 2)."""
    arr = np.asarray(x)
    return arr[..., 0] + 1j * arr[..., 1]


# ---------------------------------------------------------------------------
# Transmitters


@dataclasses.dataclass
class Transmitter:
    """Uncoded random-bit transmitter (Transmitter.py:14-118 equivalent).

    ``modulation``: 'bpsk' | 'qam' | 'mpsk'. For QAM/MPSK supply
    ``encoding_table`` (defaults to Gray) and ``order`` (sqrt_M / M).
    """

    sequence_len: int
    modulation: str = "bpsk"
    order: int = 2
    encoding_table: np.ndarray | None = None

    def __post_init__(self):
        if self.modulation not in ("bpsk", "qam", "mpsk"):
            raise ValueError(self.modulation)
        if self.modulation != "bpsk" and self.encoding_table is None:
            k = int(np.log2(self.order))
            self.encoding_table = gray_encoding_table(k)

    def map_bits(self, bits: jnp.ndarray) -> jnp.ndarray:
        if self.modulation == "bpsk":
            return bpsk_map(bits)
        if self.modulation == "qam":
            return qam_map(bits, self.encoding_table, self.order)
        return mpsk_map(bits, self.encoding_table, self.order)

    def transmit(self, key: jax.Array, batch: int):
        """Returns (symbols, bits): random uniform bits, mapped symbols."""
        bits = jax.random.bernoulli(
            key, 0.5, (self.sequence_len, batch)
        ).astype(jnp.int8)
        return self.map_bits(bits), bits


@dataclasses.dataclass
class LDPCTransmitter:
    """Encoded transmitter: random info bits -> GF(2) encode -> modulate.

    Batched, on-device equivalent of LDPC_BPSK_Transmitter /
    LDPC_QAM_Transmitter / LDPC_MPSK_Transmitter (LDPC_Transmitter.py:14-215);
    the per-codeword ``encode_c`` host loop (:117-119) becomes one batched
    device encode.
    """

    encoder: object  # encode.LDPCEncoder
    modulation: str = "bpsk"
    order: int = 2
    encoding_table: np.ndarray | None = None

    def __post_init__(self):
        self._mapper = Transmitter(
            sequence_len=0,
            modulation=self.modulation,
            order=self.order,
            encoding_table=self.encoding_table,
        )
        self._encode = self.encoder.device_encoder()

    def transmit(self, key: jax.Array, batch: int):
        """Returns (symbols, info_bits, codeword_bits)."""
        info = jax.random.bernoulli(
            key, 0.5, (self.encoder.k, batch)
        ).astype(jnp.int8)
        codeword = self._encode(info)
        return self._mapper.map_bits(codeword), info, codeword
