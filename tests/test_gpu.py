"""The decode path on the card against the CPU backend, in one process.

Every test here takes the ``gpu`` fixture and skips when JAX finds no GPU;
``python chip_smoke.py`` runs them on the card as its phase 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig
from informationbottleneckdecodingldpc_tpu.decode import (
    DeviceTrellis,
    belief_propagation_decode,
    ib_lut_decode,
    min_sum_decode,
)
from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder
from informationbottleneckdecodingldpc_tpu.models import get_model
from informationbottleneckdecodingldpc_tpu.ops import lut_fold

pytestmark = pytest.mark.gpu

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "results", "configs")


def _on(device, fn):
    """Build and run ``fn()`` with ``device`` as the default device; the
    result as numpy."""
    with jax.default_device(device):
        return jax.tree_util.tree_map(np.asarray, fn())


def test_ib_decode_gpu_equals_cpu(gpu, cpu):
    spec = get_model("wlan-1296")
    cfg = DecoderConfig.load(os.path.join(CONFIGS, "wlan_T16_0.8.npz"))
    n = spec.make_h().shape[1]
    channel = np.random.default_rng(0).integers(0, 16, (n, 64)).astype(np.int32)

    def run():
        res = ib_lut_decode(
            spec.make_layout(), DeviceTrellis.from_tables(cfg.tables),
            jnp.asarray(channel), max_iters=10, early_exit=False,
        )
        return res.outputs, res.unsatisfied

    g, c = _on(gpu, run), _on(cpu, run)
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])


@pytest.mark.parametrize("decoder", [min_sum_decode, belief_propagation_decode])
def test_float_decode_gpu_matches_cpu(gpu, cpu, decoder):
    spec = get_model("wlan-1296")
    n = spec.make_h().shape[1]
    llrs = np.random.default_rng(1).normal(1.0, 1.6, (n, 64)).astype(np.float32)

    def run():
        return decoder(
            spec.make_layout(), jnp.asarray(llrs), max_iters=10, early_exit=False
        ).outputs

    np.testing.assert_allclose(_on(gpu, run), _on(cpu, run), rtol=1e-5, atol=1e-5)


def test_device_encoder_gpu_equals_host(gpu):
    encoder = LDPCEncoder(get_model("wlan-1296").make_h())
    info = np.random.default_rng(2).integers(0, 2, (encoder.k, 256), dtype=np.int8)
    dev = jax.jit(encoder.device_encoder())(jax.device_put(info, gpu))
    np.testing.assert_array_equal(np.asarray(dev), encoder.encode(info))


@pytest.mark.parametrize("t", [16, 32])
@pytest.mark.parametrize("mode", ["take", "select", "packed"])
def test_lookup_lowerings_on_gpu(gpu, mode, t):
    rng = np.random.default_rng(3)
    lut = rng.integers(0, t, size=(t, t)).astype(np.int32)
    a = rng.integers(0, t, size=(64, 256)).astype(np.int32)
    b = rng.integers(0, t, size=(64, 256)).astype(np.int32)
    lut_fold.set_lookup_mode(mode)
    try:
        got = jax.jit(lambda l, x, y: lut_fold.pairwise_lookup(l, x, y, vmax=t))(
            *(jax.device_put(v, gpu) for v in (lut, a, b))
        )
    finally:
        lut_fold.set_lookup_mode(None)
    np.testing.assert_array_equal(np.asarray(got), lut[a, b])
