"""Smoke test of the BER-simulation main path on the GPU.

Run from the repository root on a machine with an NVIDIA card:

    python chip_smoke.py               # phases 0 and a-e on one GPU
    python chip_smoke.py --devices 4   # phase a on a 4-GPU mesh vs one GPU

Phases, all in this one process except phase 0, whose pytest child ends
before this process first touches JAX (one JAX process per card):

  0  the card-only tests (``pytest tests/ -m gpu``);
  a  wlan-1296 IB |T|=16, i_max=50 (results/configs/wlan_T16_0.8.npz),
     all-zeros chain, 0.8 dB: one step at batch 256 on the GPU and on the CPU
     backend, whose counters must be identical; then
     ``BERSimulator.run_point`` at batch 4096;
  b  the same decoder on the encoded chain: the device encoder against the
     host encoder, bit for bit, at batch 256; counters against the CPU;
  c  wlan-1296 min-sum and quantized BP, 50 iterations, 2.0 dB, batch 4096;
     counters against the CPU at batch 256;
  d  dvbs2-64800 IB |T|=16 (dvbs2_T16_0.6.npz), encoded, 1.0 dB, batch 512;
     counters against the CPU at batch 8;
  e  one sweep point through ``cli.simulate.main``: wlan-1296 min-sum,
     QAM16, encoded chain, 4.2 dB.

Counters against the CPU must be identical, except where float32 results
may differ between backends (the erfinv of the AWGN noise, the order of
sums, exp/log in BP and the demapper): there both are printed and the GPU's
BER and FER must lie inside the CPU run's 95% binomial interval. Phase a and
the encoder check allow no difference.

Each phase prints compile seconds, the median step seconds (timed with
``block_until_ready``), coded Mbit/s, mean iterations, the device's
``peak_bytes_in_use`` so far and the counters. With ``--devices 4`` the
script runs phase a on a 4-card mesh at 4096 codewords per card and on one
card at 16384, whose counters must be bitwise identical, and nothing else.

Exits non-zero, and prints no result, when there is no GPU. The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NO_LIMIT = 1 << 62  # min_errors that is never reached: run to max_blocks


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card (a child process
    that stays off JAX); fails when there is no NVIDIA driver."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=120,
    )
    return out.stdout.strip()


def run_gpu_tests() -> None:
    """Phase 0: the tests marked ``gpu``, in a child process."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(REPO, "tests"), "-m",
         "gpu", "-q", "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    print(proc.stdout[-4000:], flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"phase 0: card-only tests failed (pytest exit {proc.returncode})")
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    emit("0", {"seconds": time.perf_counter() - t0, "pytest": summary})


def emit(phase: str, record: dict) -> None:
    print(f"phase {phase}: {json.dumps(record)}", flush=True)


def ci95(k: int, n: int) -> tuple[float, float]:
    """Wilson score 95% interval of a binomial proportion k/n."""
    z = 1.96
    p = k / n
    d = 1.0 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1.0 - p) / n + z * z / (4.0 * n * n)) / d
    return c - h, c + h


def compare(label: str, gpu, cpu, exact: bool) -> None:
    """Fail unless the GPU's counters equal the CPU's, or (``exact`` False)
    its BER and FER lie inside the CPU run's 95% binomial intervals."""
    g = (gpu.errors, gpu.frame_errors, gpu.blocks)
    c = (cpu.errors, cpu.frame_errors, cpu.blocks)
    if g == c:
        print(f"{label}: counters identical on GPU and CPU "
              f"(errors, frame_errors, blocks) = {g}", flush=True)
        return
    print(f"{label}: counters differ: GPU {g}, CPU {c}", flush=True)
    if exact or gpu.blocks != cpu.blocks:
        raise SystemExit(f"{label}: GPU counters {g} != CPU counters {c}")
    ber_lo, ber_hi = ci95(cpu.errors, cpu.bits_counted)
    fer_lo, fer_hi = ci95(cpu.frame_errors, cpu.blocks)
    print(f"{label}: GPU BER {gpu.ber:.6e} vs CPU 95% [{ber_lo:.6e}, {ber_hi:.6e}]; "
          f"GPU FER {gpu.fer:.6e} vs CPU 95% [{fer_lo:.6e}, {fer_hi:.6e}]", flush=True)
    if not (ber_lo <= gpu.ber <= ber_hi and fer_lo <= gpu.fer <= fer_hi):
        raise SystemExit(f"{label}: GPU BER/FER outside the CPU run's 95% interval")


def counters(make_sim, ebn0: float, blocks: int, device):
    """Build a simulator and run ``blocks`` codewords of one point with
    ``device`` as JAX's default device; returns its PointResult."""
    import jax

    with jax.default_device(device):
        sim = make_sim()
        res = sim.run_point(ebn0, min_errors=NO_LIMIT, max_blocks=blocks)
        placed = sim.quantizer_for(ebn0).cdf.devices()
    if placed != {device}:
        raise SystemExit(f"step inputs on {placed}, expected {device}")
    return res


def against_cpu(label, make_sim, ebn0, batch, gpu, cpu, exact) -> None:
    """One step of ``make_sim(batch)`` on the GPU and on the CPU backend."""
    g, c = (counters(lambda: make_sim(batch), ebn0, batch, d) for d in (gpu, cpu))
    compare(label, g, c, exact)


def measure(phase: str, sim, ebn0: float, steps: int, device, **extra) -> dict:
    """Compile and time one dispatch, then run ``steps`` dispatches through
    ``run_point``; prints and returns the phase record."""
    from informationbottleneckdecodingldpc_tpu.utils.benchmarks import (
        time_sim_steps,
    )

    t = time_sim_steps(sim, ebn0, dispatches=max(steps, 3))
    res = sim.run_point(
        ebn0, min_errors=NO_LIMIT, max_blocks=sim.batch_total * steps
    )
    record = {
        "batch": sim.batch_total,
        "ebn0_db": ebn0,
        "compile_s": t["compile_s"],
        "step_s": t["step_s"],
        "coded_mbps": t["coded_bits_per_s"] / 1e6,
        "mean_iterations": res.mean_iterations,
        "peak_bytes_in_use": peak_bytes(device),
        "errors": res.errors,
        "frame_errors": res.frame_errors,
        "blocks": res.blocks,
        "ber": res.ber,
        "fer": res.fer,
        "run_point_coded_mbps": res.coded_bits_per_s / 1e6,
        **extra,
    }
    emit(phase, record)
    return record


def peak_bytes(device):
    """The device's ``peak_bytes_in_use`` so far (None where the backend
    keeps no memory statistics)."""
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def load_config(name: str):
    from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig

    return DecoderConfig.load(os.path.join(REPO, "results", "configs", f"{name}.npz"))


def ib_sim(spec, cfg, batch, n_devices=1, chain="allzero", encoder=None):
    from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis
    from informationbottleneckdecodingldpc_tpu.sim import BERSimulator

    return BERSimulator(
        spec.make_layout(),
        "ib",
        trellis=DeviceTrellis.from_tables(cfg.tables),
        cardinality_t_channel=cfg.tables.cardinality_t_channel,
        chain=chain,
        encoder=encoder,
        batch_per_device=batch,
        n_devices=n_devices,
        seed=SEED,
    )


def phase_a(gpu, cpu, batch_cmp=256, batch=4096, steps=3) -> None:
    import jax

    from informationbottleneckdecodingldpc_tpu.models import get_model

    spec, cfg = get_model("wlan-1296"), load_config("wlan_T16_0.8")
    # After exact threefry uniforms the all-zeros IB chain is integer.
    against_cpu("phase a", lambda b: ib_sim(spec, cfg, b), 0.8, batch_cmp,
                gpu, cpu, exact=True)
    with jax.default_device(gpu):
        measure("a", ib_sim(spec, cfg, batch), 0.8, steps, gpu)


def phase_b(gpu, cpu, batch_cmp=256, batch=4096, steps=3) -> None:
    import jax
    import numpy as np

    from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_tpu.models import get_model

    spec, cfg = get_model("wlan-1296"), load_config("wlan_T16_0.8")
    encoder = LDPCEncoder(spec.make_h())
    info = np.random.default_rng(SEED).integers(
        0, 2, (encoder.k, batch_cmp), dtype=np.int8
    )
    host = encoder.encode(info)
    if encoder.check(host).any():
        raise SystemExit("phase b: host encoder emitted a non-codeword")
    enc = jax.jit(encoder.device_encoder())
    x = jax.device_put(info, gpu)
    t0 = time.perf_counter()
    dev = jax.block_until_ready(enc(x))
    enc_compile = time.perf_counter() - t0
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(enc(x))
        ts.append(time.perf_counter() - t0)
    if not np.array_equal(np.asarray(dev), host):
        bad = int(np.sum(np.asarray(dev) != host))
        raise SystemExit(f"phase b: device encoder differs from host in {bad} bits")
    print(f"phase b: device encoder ({encoder.method}, int32 matmul) equals the "
          f"host encoder on {batch_cmp} codewords", flush=True)
    make = lambda b: ib_sim(spec, cfg, b, chain="encoded", encoder=encoder)
    against_cpu("phase b", make, 0.8, batch_cmp, gpu, cpu, exact=False)
    with jax.default_device(gpu):
        measure("b", make(batch), 0.8, steps, gpu,
                encoder_compile_s=enc_compile,
                encoder_step_s=sorted(ts)[len(ts) // 2],
                encoder_batch=batch_cmp)


def phase_c(gpu, cpu, batch_cmp=256, batch=4096, steps=3) -> None:
    import jax

    from informationbottleneckdecodingldpc_tpu.models import get_model
    from informationbottleneckdecodingldpc_tpu.sim import BERSimulator

    spec = get_model("wlan-1296")
    for decoder in ("minsum", "bp"):
        make = lambda b: BERSimulator(
            spec.make_layout(), decoder, max_iters=50, chain="allzero",
            llr_source="quantized",
            cardinality_t_channel=spec.cardinality_t_channel,
            batch_per_device=b, n_devices=1, seed=SEED,
        )
        against_cpu(f"phase c {decoder}", make, 2.0, batch_cmp, gpu, cpu,
                    exact=False)
        with jax.default_device(gpu):
            measure(f"c {decoder}", make(batch), 2.0, steps, gpu)


def phase_d(gpu, cpu, batch_cmp=8, batch=512, steps=2) -> None:
    import jax

    from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_tpu.models import get_model

    spec, cfg = get_model("dvbs2-64800"), load_config("dvbs2_T16_0.6")
    encoder = LDPCEncoder(spec.make_h())
    make = lambda b: ib_sim(spec, cfg, b, chain="encoded", encoder=encoder)
    against_cpu("phase d", make, 1.0, batch_cmp, gpu, cpu, exact=False)
    with jax.default_device(gpu):
        measure("d", make(batch), 1.0, steps, gpu)


def phase_e(gpu, batch=4096, blocks=16384) -> None:
    from informationbottleneckdecodingldpc_tpu.cli import simulate

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "wlan_minsum_qam16.json")
        t0 = time.perf_counter()
        simulate.main([
            "--model", "wlan-1296", "--decoder", "minsum",
            "--modulation", "qam16", "--chain", "encoded",
            "--start-db", "4.2", "--max-db", "4.2", "--min-errors", "1000",
            "--batch-per-device", str(batch), "--max-blocks-per-point", str(blocks),
            "--results", path,
        ])
        seconds = time.perf_counter() - t0
        with open(path) as f:
            points = json.load(f)["points"]
    if len(points) != 1:
        raise SystemExit(f"phase e: expected one point, got {len(points)}")
    p = points[0]
    for k in ("ber", "fer", "coded_bits_per_s"):
        if not (isinstance(p.get(k), (int, float)) and math.isfinite(p[k])):
            raise SystemExit(f"phase e: point has no finite {k}: {p}")
    if not (0.0 <= p["ber"] < 0.5 and 0.0 <= p["fer"] <= 1.0 and p["coded_bits_per_s"] > 0):
        raise SystemExit(f"phase e: implausible point {p}")
    emit("e", {"seconds": seconds, "peak_bytes_in_use": peak_bytes(gpu), **p})


def four_devices(n=4, per_device=4096, steps=2) -> None:
    """Phase a on an n-card mesh against one card at the same global batch."""
    import jax

    from informationbottleneckdecodingldpc_tpu.models import get_model

    devices = jax.devices()
    if len(devices) < n:
        raise SystemExit(f"--devices {n}: JAX sees {len(devices)} devices")
    spec, cfg = get_model("wlan-1296"), load_config("wlan_T16_0.8")
    sim_n = ib_sim(spec, cfg, per_device, n_devices=n)
    mesh_devices = list(sim_n.mesh.devices.flat)
    if mesh_devices != devices[:n]:
        raise SystemExit(f"mesh devices {mesh_devices} != {devices[:n]}")
    rn = measure(f"a x{n}", sim_n, 0.8, steps, devices[0], n_devices=n)
    rn["coded_mbps_per_card"] = rn["coded_mbps"] / n
    peaks = [peak_bytes(d) for d in devices[:n]]
    print(f"phase a x{n}: peak_bytes_in_use per card {peaks}; "
          f"coded Mbit/s per card {rn['coded_mbps_per_card']}", flush=True)
    if min(peaks) < 2 * spec.make_layout().n_edges * per_device * 4:
        raise SystemExit(f"a card held less than its two message views: {peaks}")
    r1 = measure("a x1", ib_sim(spec, cfg, n * per_device), 0.8, steps,
                 devices[0], n_devices=1)
    print(f"phase a x1: coded Mbit/s per card {r1['coded_mbps']}", flush=True)
    keys = ("errors", "frame_errors", "blocks", "mean_iterations")
    if any(rn[k] != r1[k] for k in keys):
        raise SystemExit(
            f"{n} cards {[rn[k] for k in keys]} != one card {[r1[k] for k in keys]}"
        )
    print(f"phase a: counters on {n} cards equal one card "
          f"{dict((k, r1[k]) for k in keys)}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: only phase a on a 4-card mesh against one card")
    args = ap.parse_args(argv)

    print(card_name_and_power_limit(), flush=True)
    if args.devices == 1:
        run_gpu_tests()
    # The CPU backend is the reference of phases a-d; with no GPU, JAX
    # fails to start here.
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax

    from informationbottleneckdecodingldpc_tpu.utils.benchmarks import require_gpu
    from informationbottleneckdecodingldpc_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    device = require_gpu()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    if args.devices == 4:
        four_devices()
    else:
        for phase in (phase_a, phase_b, phase_c, phase_d):
            t0 = time.perf_counter()
            phase(gpu, cpu)
            print(f"{phase.__name__} took {time.perf_counter() - t0:.1f} s", flush=True)
        phase_e(gpu)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
