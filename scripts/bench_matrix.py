"""Decoded-throughput matrix over the reference's decode modes and codes.

Measures, on the accelerator, steady-state decoded throughput of every
scenario below through BERSimulator (the XLA decode path), timed as
utils/benchmarks.time_sim_steps does for bench.py: compile and run once
untimed, then the median of timed dispatches, each ending in
``block_until_ready``. Mean in-loop iterations come from ``run_point`` over
two further dispatches. Exits without numbers when JAX finds no GPU.

Usage:
  python scripts/bench_matrix.py --out bench_matrix.json [--only a,b]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (model, decoder, keyword overrides). The reference's four WLAN
# decode modes + both big codes; the 2.4 dB point is where early exit can
# show (mean_iterations << i_max).
SCENARIOS = {
    "wlan_ib": ("wlan-1296", "ib", dict(config="wlan_T16_0.8")),
    "wlan_ib_encoded": ("wlan-1296", "ib",
                        dict(config="wlan_T16_0.8", chain="encoded")),
    "wlan_ib_highsnr": ("wlan-1296", "ib",
                        dict(config="wlan_T16_0.8", batch=2048, ebn0=2.4)),
    "wlan_minsum": ("wlan-1296", "minsum", dict(max_iters=50, ebn0=2.0)),
    "wlan_bp_quant": ("wlan-1296", "bp", dict(max_iters=50, ebn0=2.0)),
    "wlan_T32_ib": ("wlan-1296-T32", "ib", dict(config="wlan_T32_0.6", batch=2048)),
    "regular8000_ib": ("regular-3-6-8000", "ib",
                       dict(config="regular_T16_1.05", batch=512, ebn0=1.05)),
    "regular8000_minsum": ("regular-3-6-8000", "minsum",
                           dict(batch=1024, max_iters=50, ebn0=2.0)),
    "dvbs2_ib_encoded": ("dvbs2-64800", "ib",
                         dict(config="dvbs2_T16_0.6", chain="encoded",
                              batch=128, ebn0=1.0)),
    "dvbs2_minsum": ("dvbs2-64800", "minsum",
                     dict(batch=128, max_iters=50, ebn0=1.0)),
}


def run_scenario(model, decoder, *, config=None, chain="allzero", batch=4096,
                 ebn0=None, max_iters=None):
    from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig
    from informationbottleneckdecodingldpc_tpu.decode import DeviceTrellis
    from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_tpu.models import get_model
    from informationbottleneckdecodingldpc_tpu.sim import BERSimulator
    from informationbottleneckdecodingldpc_tpu.utils.benchmarks import (
        time_sim_steps,
    )
    from informationbottleneckdecodingldpc_tpu.utils.compile_cache import REPO_ROOT

    spec = get_model(model)
    H = spec.make_h()
    kw = dict(
        chain=chain,
        count_all_bits=spec.count_all_bits and chain == "allzero",
        batch_per_device=batch,
        n_devices=1,
        seed=0,
    )
    if decoder == "ib":
        cfg = DecoderConfig.load(
            os.path.join(REPO_ROOT, "results", "configs", f"{config}.npz")
        )
        kw["trellis"] = DeviceTrellis.from_tables(cfg.tables)
        kw["cardinality_t_channel"] = cfg.tables.cardinality_t_channel
    else:
        kw["max_iters"] = max_iters or spec.decode_i_max
    if chain == "encoded":
        kw["encoder"] = LDPCEncoder(H)
    sim = BERSimulator(spec.make_layout(H), decoder, **kw)
    point = ebn0 if ebn0 is not None else spec.design_ebn0_db
    t = time_sim_steps(sim, point)
    res = sim.run_point(point, min_errors=1 << 62, max_blocks=2 * sim.batch_total)
    return {
        "model": model, "decoder": decoder, "chain": chain, "batch": batch,
        "ebn0_db": point, "coded_mbps": t["coded_bits_per_s"] / 1e6,
        "step_s": t["step_s"], "compile_s": t["compile_s"],
        "mean_iterations": res.mean_iterations,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--only", default="", help="comma-separated scenario names")
    args = ap.parse_args(argv)

    from informationbottleneckdecodingldpc_tpu.utils.benchmarks import require_gpu
    from informationbottleneckdecodingldpc_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    out = {"device": require_gpu(), "unit": "coded Mbit/s", "scenarios": {}}
    names = [n for n in args.only.split(",") if n] or list(SCENARIOS)
    for name in names:
        model, decoder, kw = SCENARIOS[name]
        out["scenarios"][name] = run_scenario(model, decoder, **kw)
        print(name, json.dumps(out["scenarios"][name]), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
