"""Shared throughput measurement used by bench.py and scripts/bench_matrix.py.

Both surfaces report the same number for the same scenario, so the scenario
definition and the timing policy live here: a BERSimulator step at a fixed
(batch, steps_per_dispatch), compiled and run once untimed, then the median
of ``dispatches`` timed runs, each ending in ``block_until_ready``.
"""

from __future__ import annotations

import time


# The headline scenario (BASELINE.md north star: decoded Mbit/s per card at
# i_max=50): WLAN 802.11n N=1296 R=1/2 irregular IB decoder with message
# alignment, |T|=16, all-zeros direct-sampling chain at the 0.8 dB design
# point (low enough that decoding runs essentially all 49 in-loop
# iterations). One fixed configuration — no tuning grid.
HEADLINE = dict(
    model="wlan-1296",
    config="wlan_T16_0.8",
    decoder="ib",
    chain="allzero",
    batch=4096,
    steps_per_dispatch=1,
    ebn0_db=0.8,
)


def require_gpu() -> dict:
    """The platform, kind and count of JAX's devices; exits unless they
    are GPUs. A measurement taken elsewhere is not a device number."""
    import jax

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX found {info}")
    return info


def time_sim_steps(sim, ebn0_db: float, dispatches: int = 6) -> dict:
    """Compile seconds and median steady-state seconds of one dispatch of a
    BERSimulator at one SNR point, plus the coded bits/s that implies."""
    import jax
    import jax.numpy as jnp

    from ..channel.awgn import sigma2_from_ebn0_db

    qt = sim.quantizer_for(ebn0_db)
    sigma2 = jnp.float32(sigma2_from_ebn0_db(ebn0_db, sim.layout.code_rate))
    root = jax.random.PRNGKey(7)
    run = lambda i: jax.block_until_ready(
        sim._step(root, jnp.uint32(i * sim.steps_per_dispatch), qt, sigma2)
    )
    t0 = time.perf_counter()
    run(1000)  # compile + first run
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(dispatches):
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[len(times) // 2]
    bits = sim.layout.n_vars * sim.batch_total * sim.steps_per_dispatch
    return {
        "compile_s": compile_s,
        "step_s": step_s,
        "coded_bits_per_s": bits / step_s,
    }


def build_headline_sim():
    """The headline BERSimulator, exactly as bench_matrix's wlan_ib."""
    from ..construct import DecoderConfig
    from ..decode import DeviceTrellis
    from ..models import get_model
    from ..sim import BERSimulator
    from .compile_cache import REPO_ROOT

    import os

    spec = get_model(HEADLINE["model"])
    cfg = DecoderConfig.load(
        os.path.join(REPO_ROOT, "results", "configs", f"{HEADLINE['config']}.npz")
    )
    return BERSimulator(
        spec.make_layout(),
        "ib",
        trellis=DeviceTrellis.from_tables(cfg.tables),
        cardinality_t_channel=cfg.tables.cardinality_t_channel,
        chain=HEADLINE["chain"],
        count_all_bits=False,
        batch_per_device=HEADLINE["batch"],
        n_devices=1,
        seed=0,
        steps_per_dispatch=HEADLINE["steps_per_dispatch"],
    )
