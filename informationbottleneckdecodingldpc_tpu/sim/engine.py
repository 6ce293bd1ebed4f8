"""Monte-Carlo BER engine: sharded, jitted, resumable.

Redesign of the reference's per-scenario simulation scripts
(Regular_LDPC_Decoding/BPSK/BER_simulation_OpenCL.py:81-137 and the WLAN /
DVB-S2 variants): the entire per-block pipeline — bit generation, encoding,
AWGN, quantization, iterative decode, error counting — is one jitted step
compiled once per sweep (quantizer tables are runtime arguments), optionally
``shard_map``-ed over a data-parallel device mesh with psum'd error counters
and a psum'd batch-global early-exit test (SURVEY.md §5 "distributed
communication backend"). The host loop only accumulates scalar counters until
``min_errors`` like the reference's while loop
(BER_simulation_OpenCL.py:98-119).

Chains:
- ``allzero``: direct quantizer-cluster (or LLR) sampling of the all-zeros
  codeword — the reference's fast path, valid by code linearity and quantizer
  symmetry (SURVEY.md §3.3 note);
- ``encoded``: random info bits -> GF(2) encode -> BPSK -> AWGN -> threshold
  quantize -> decode, errors counted against the transmitted bits
  (BER_simulation_OpenCL_enc.py:120-135).

Modulations: BPSK is the primary chain (the only one whose construction path
works in the reference, SURVEY.md §7.4). ``modulation='qam'|'mpsk'`` runs the
encoded chain through the I/Q mappers (channel.modulation) and the exact
soft demapper (channel.demap) into the float decoders — the end-to-end M-ary
path the reference intended but left broken (AWGN_Quantizer_Mary absent,
AWGN_Discrete_Density_Evolution.py:6-7).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..channel.awgn import sigma2_from_ebn0_db
from ..channel.demap import mpsk_bit_llrs, n0_from_sigma2, qam_bit_llrs
from ..channel.modulation import bpsk_map, gray_encoding_table, mpsk_map, qam_map
from ..channel.quantizer import (
    DeviceQuantizerTables,
    build_quantizer_tables,
    device_tables,
    quantize_llr_with,
    quantize_with,
    sample_clusters_from_uniform,
    sample_llrs_from_uniform,
)
from ..decode.bp import belief_propagation_decode
from ..decode.graph_arrays import DecodeLayout
from ..decode.ib_lut import DeviceTrellis, ib_lut_decode
from ..decode.min_sum import min_sum_decode
from ..parallel.mesh import DATA_AXIS, make_mesh, psum_convergence_reduce


@dataclasses.dataclass
class PointResult:
    """Result of one Eb/N0 point."""

    ebn0_db: float
    ber: float
    fer: float
    errors: int
    frame_errors: int
    blocks: int
    bits_counted: int
    elapsed_s: float
    coded_bits_per_s: float
    info_bits_per_s: float
    mean_iterations: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PointCheckpoint:
    """Mid-point resumable state (SNR value, RNG key, counters)."""

    ebn0_db: float
    step_index: int
    errors: int
    frame_errors: int
    blocks: int
    iters_sum: float


class BERSimulator:
    """Reusable, compiled BER simulator for one (code, decoder) pair."""

    def __init__(
        self,
        layout: DecodeLayout,
        decoder: str,  # 'ib' | 'minsum' | 'bp'
        *,
        trellis: DeviceTrellis | None = None,
        max_iters: int | None = None,
        chain: str = "allzero",  # 'allzero' | 'encoded'
        llr_source: str = "quantized",  # 'quantized' | 'true' (float decoders)
        count_all_bits: bool = False,
        cardinality_t_channel: int = 16,
        ad_max_abs: float = 3.0,
        cardinality_y_channel: int = 2000,
        batch_per_device: int = 128,
        n_devices: int | None = 1,
        early_exit: bool = True,
        encoder=None,
        seed: int = 0,
        steps_per_dispatch: int = 1,
        modulation: str = "bpsk",  # 'bpsk' | 'qam' | 'mpsk'
        mod_order: int = 2,  # sqrt(M) for QAM, M for MPSK
    ):
        if decoder == "ib":
            if trellis is None:
                raise ValueError("ib decoder requires trellis tables")
            max_iters = max_iters or trellis.i_max
        elif max_iters is None:
            raise ValueError("float decoders require max_iters")
        self.layout = layout
        self.decoder = decoder
        self.trellis = trellis
        self.max_iters = int(max_iters)
        self.chain = chain
        self.llr_source = llr_source
        self.count_all_bits = bool(count_all_bits)
        self.cardinality_t_channel = int(cardinality_t_channel)
        self.ad_max_abs = float(ad_max_abs)
        self.cardinality_y_channel = int(cardinality_y_channel)
        self.batch_per_device = int(batch_per_device)
        self.early_exit = bool(early_exit)
        self.seed = int(seed)
        self.modulation = modulation
        self.mod_order = int(mod_order)
        if modulation not in ("bpsk", "qam", "mpsk"):
            raise ValueError(f"unknown modulation {modulation!r}")
        if modulation != "bpsk":
            # M-ary chains: float decoders on exact demapped LLRs (the IB
            # construction path is BPSK-only, as in the reference).
            if decoder == "ib" or llr_source != "true":
                raise ValueError(
                    "qam/mpsk require a float decoder with llr_source='true'"
                )
            if chain != "encoded":
                raise ValueError(
                    "qam/mpsk require the encoded chain (the all-zeros "
                    "shortcut needs the BPSK/quantizer symmetry)"
                )
            k = (
                2 * int(np.log2(self.mod_order))
                if modulation == "qam"
                else int(np.log2(self.mod_order))
            )
            if layout.n_vars % k:
                raise ValueError(
                    f"codeword length {layout.n_vars} not divisible by "
                    f"{k} bits/symbol"
                )
            self._bits_per_symbol = k
            self._encoding_table = gray_encoding_table(
                k // 2 if modulation == "qam" else k
            )
        # Monte-Carlo steps executed per device dispatch (lax.scan): amortizes
        # the per-dispatch host round trip (launch + counter readback), which
        # dominates when one block is small (the reference pays the same cost
        # per block via its per-iteration syndrome readback, SURVEY.md §3.2). The
        # per-step key stream is fold_in(root, absolute_step), so counters are
        # independent of this value.
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))

        devices = jax.devices()
        if n_devices is None:
            n_devices = len(devices)
        self.n_devices = int(n_devices)
        self.mesh = make_mesh(self.n_devices) if self.n_devices > 1 else None
        self.batch_total = self.batch_per_device * self.n_devices

        self.prefix_len = (
            layout.n_vars if self.count_all_bits else layout.data_len
        )
        self._encode_device = None
        if chain == "encoded":
            if encoder is None:
                raise ValueError("encoded chain requires an LDPCEncoder")
            self._encode_device = encoder.device_encoder()
            if self._encode_device is None:
                raise ValueError(
                    "encoder has no device path for this code; use host "
                    "pre-encoding or the allzero chain"
                )
        self._step = self._build_step()
        self._quant_cache: dict[float, DeviceQuantizerTables] = {}

    # ------------------------------------------------------------------
    def _decode(self, channel_input, convergence_reduce):
        if self.decoder == "ib":
            return ib_lut_decode(
                self.layout,
                self.trellis,
                channel_input,
                max_iters=self.max_iters,
                early_exit=self.early_exit,
                convergence_reduce=convergence_reduce,
            )
        fn = min_sum_decode if self.decoder == "minsum" else belief_propagation_decode
        return fn(
            self.layout,
            channel_input,
            max_iters=self.max_iters,
            early_exit=self.early_exit,
            convergence_reduce=convergence_reduce,
        )

    def _count_errors(self, outputs, reference_bits):
        """Bit decisions vs transmitted bits over the counted prefix.

        IB decoder: bit = (cluster < T/2) (discrete_LDPC_decoder.py:297-300);
        float decoders: bit = (llr < 0) (bp_decoder_irreg.py:288-295).
        """
        prefix = outputs[: self.prefix_len]
        if self.decoder == "ib":
            hard = prefix < (self.trellis.t_decoder // 2)
        else:
            hard = prefix < 0
        wrong = hard != reference_bits[: self.prefix_len].astype(bool)
        errors = jnp.sum(wrong, axis=0, dtype=jnp.int32)  # per codeword
        return errors

    def _step_body(
        self, key, shard_offset, qt: DeviceQuantizerTables, sigma2, convergence_reduce
    ):
        """One Monte-Carlo block on this shard.

        All randomness is derived from per-*codeword* keys
        ``fold_in(step_key, global_codeword_index)``, so the accumulated
        counters depend only on (seed, step, batch_total) — bitwise identical
        for every mesh shape / batch_per_device split of the same global
        batch (SURVEY.md §4.5 invariance requirement)."""
        n_vars = self.layout.n_vars
        batch = self.batch_per_device
        idx = shard_offset + jnp.arange(batch, dtype=jnp.uint32)
        cw_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(cw_keys)  # (batch, 3, ..)
        k_bits, k_noise, k_quant = ks[:, 0], ks[:, 1], ks[:, 2]

        def uniform_plane(keys):  # (n_vars, batch), column j from keys[j]
            return jax.vmap(
                lambda k: jax.random.uniform(k, (n_vars,), dtype=jnp.float32),
                out_axes=1,
            )(keys)

        def normal_plane(keys):
            return jax.vmap(
                lambda k: jax.random.normal(k, (n_vars,), dtype=jnp.float32),
                out_axes=1,
            )(keys)

        if self.chain == "allzero":
            bits = jnp.zeros((n_vars, batch), dtype=jnp.int32)
            if self.decoder == "ib":
                u = uniform_plane(k_quant)
                channel_input = sample_clusters_from_uniform(qt.cdf, u, bits)
            elif self.llr_source == "quantized":
                u = uniform_plane(k_quant)
                channel_input = sample_llrs_from_uniform(qt.cdf, qt.llrs, u, bits)
            else:
                y = bpsk_map(bits) + jnp.sqrt(sigma2) * normal_plane(k_noise)
                channel_input = 2.0 * y / sigma2
            ref_bits = bits
        else:
            k = self.layout.data_len
            info = jax.vmap(
                lambda kk: jax.random.bernoulli(kk, 0.5, (k,)), out_axes=1
            )(k_bits).astype(jnp.int8)
            codeword = self._encode_device(info)
            ref_bits = codeword
            if self.modulation != "bpsk":
                mapper = qam_map if self.modulation == "qam" else mpsk_map
                sym = mapper(codeword, self._encoding_table, self.mod_order)
                n0 = n0_from_sigma2(sigma2, self._bits_per_symbol)
                noise = jax.vmap(
                    lambda kk: jax.random.normal(
                        kk, (n_vars // self._bits_per_symbol, 2), jnp.float32
                    ),
                    out_axes=1,
                )(k_noise)
                y = sym + jnp.sqrt(n0 / 2.0) * noise
                demap = (
                    qam_bit_llrs if self.modulation == "qam" else mpsk_bit_llrs
                )
                channel_input = demap(
                    y, self._encoding_table, self.mod_order, n0
                )
            else:
                y = bpsk_map(codeword) + jnp.sqrt(sigma2) * normal_plane(
                    k_noise
                )
                if self.decoder == "ib":
                    channel_input = quantize_with(qt.limits, y)
                elif self.llr_source == "quantized":
                    channel_input = quantize_llr_with(qt.limits, qt.llrs, y)
                else:
                    channel_input = 2.0 * y / sigma2

        res = self._decode(channel_input, convergence_reduce)
        errors = self._count_errors(res.outputs, ref_bits)
        frame_errors = (errors > 0).astype(jnp.int32)
        return (
            jnp.sum(errors, dtype=jnp.int32),
            jnp.sum(frame_errors, dtype=jnp.int32),
            res.iterations,
        )

    def _build_step(self):
        K = self.steps_per_dispatch

        def scanned(step_key_fn, qt, sigma2):
            """Run K Monte-Carlo steps in one dispatch; sum the counters."""
            def body(carry, j):
                e, f, it = step_key_fn(j, qt, sigma2)
                ce, cf, cit = carry
                return (ce + e, cf + f, cit + it), None

            init = (jnp.int32(0), jnp.int32(0), jnp.float32(0.0))
            (e, f, it), _ = jax.lax.scan(
                body, init, jnp.arange(K, dtype=jnp.uint32)
            )
            return e, f, it / K

        if self.mesh is None:
            @jax.jit
            def step(root_key, step_index, qt, sigma2):
                def one(j, qt, sigma2):
                    key = jax.random.fold_in(root_key, step_index + j)
                    return self._step_body(key, 0, qt, sigma2, None)

                return scanned(one, qt, sigma2)

            return step

        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        reduce = psum_convergence_reduce(DATA_AXIS)
        per_device = self.batch_per_device

        def shard_body(root_key, step_index, qt, sigma2):
            # The step key is replicated; each shard derives its global
            # codeword offset from its mesh position, so per-codeword keys —
            # and therefore the counters — are mesh-shape-invariant.
            offset = jax.lax.axis_index(DATA_AXIS).astype(jnp.uint32) * per_device

            def one(j, qt, sigma2):
                key = jax.random.fold_in(root_key, step_index + j)
                err, ferr, iters = self._step_body(
                    key, offset, qt, sigma2, reduce
                )
                # psum makes each step's counters replicated, the type of
                # the scan carry that sums them (the early-exit while_loop
                # already runs in lockstep via the psum'd convergence test).
                return (
                    jax.lax.psum(err, DATA_AXIS),
                    jax.lax.psum(ferr, DATA_AXIS),
                    jax.lax.psum(iters, DATA_AXIS) / self.n_devices,
                )

            return scanned(one, qt, sigma2)

        sharded = shard_map(
            shard_body,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=(P(), P(), P()),
        )
        return jax.jit(sharded)

    # ------------------------------------------------------------------
    def quantizer_for(self, ebn0_db: float) -> DeviceQuantizerTables:
        key = round(float(ebn0_db), 6)
        if key not in self._quant_cache:
            sigma2 = float(sigma2_from_ebn0_db(ebn0_db, self.layout.code_rate))
            tables = build_quantizer_tables(
                sigma2,
                self.ad_max_abs,
                self.cardinality_t_channel,
                self.cardinality_y_channel,
            )
            self._quant_cache[key] = device_tables(tables)
        return self._quant_cache[key]

    def run_point(
        self,
        ebn0_db: float,
        min_errors: int = 7000,
        max_blocks: int = 10_000_000,
        verbose: bool = False,
        progress_every: int = 50,
        checkpoint: PointCheckpoint | None = None,
        on_progress: Callable[[PointCheckpoint], None] | None = None,
    ) -> PointResult:
        """Accumulate blocks until ``min_errors`` bit errors (reference
        stopping rule, BER_simulation_OpenCL.py:52,98)."""
        sigma2 = jnp.float32(sigma2_from_ebn0_db(ebn0_db, self.layout.code_rate))
        qt = self.quantizer_for(ebn0_db)
        root = jax.random.fold_in(
            jax.random.PRNGKey(self.seed), int(round(ebn0_db * 1000))
        )

        state = checkpoint or PointCheckpoint(
            ebn0_db=float(ebn0_db), step_index=0, errors=0, frame_errors=0,
            blocks=0, iters_sum=0.0,
        )
        K = self.steps_per_dispatch
        blocks_per_dispatch = self.batch_total * K
        start = time.time()
        while state.errors < min_errors and state.blocks < max_blocks:
            err, ferr, iters = self._step(
                root, jnp.uint32(state.step_index), qt, sigma2
            )
            state.errors += int(err)
            state.frame_errors += int(ferr)
            state.blocks += blocks_per_dispatch
            state.iters_sum += float(jnp.mean(iters)) * blocks_per_dispatch
            state.step_index += K
            if verbose and state.step_index % progress_every == 0:
                elapsed = time.time() - start
                ber = state.errors / max(state.blocks * self.prefix_len, 1)
                rate = state.blocks * self.layout.n_vars / max(elapsed, 1e-9)
                eta_min = (
                    (min_errors * elapsed / max(state.errors, 1)) - elapsed
                ) / 60
                print(
                    f"EbN0={ebn0_db:.2f} dB errors={state.errors} "
                    f"BER~{ber:.3e} coded_bps={rate:.3e} eta_min={eta_min:.1f}",
                    flush=True,
                )
            if on_progress is not None:
                on_progress(state)
        elapsed = time.time() - start

        bits_counted = state.blocks * self.prefix_len
        coded_bits = state.blocks * self.layout.n_vars
        info_bits = state.blocks * self.layout.data_len
        return PointResult(
            ebn0_db=float(ebn0_db),
            ber=state.errors / max(bits_counted, 1),
            fer=state.frame_errors / max(state.blocks, 1),
            errors=state.errors,
            frame_errors=state.frame_errors,
            blocks=state.blocks,
            bits_counted=bits_counted,
            elapsed_s=elapsed,
            coded_bits_per_s=coded_bits / max(elapsed, 1e-9),
            info_bits_per_s=info_bits / max(elapsed, 1e-9),
            mean_iterations=state.iters_sum / max(state.blocks, 1),
        )
