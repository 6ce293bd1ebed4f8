"""Headline benchmark: decoded throughput of the flagship IB LUT decoder.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Scenario: the shared HEADLINE definition
(informationbottleneckdecodingldpc_tpu/utils/benchmarks.py) — WLAN 802.11n
N=1296 R=1/2 irregular IB decoder with message alignment, |T|=16, i_max=50,
all-zeros direct-sampling chain at the 0.8 dB design point, batch 4096,
compiled by XLA. Exits without a number when JAX finds no GPU.
"""

import json
import os


def main():
    from informationbottleneckdecodingldpc_tpu.utils.benchmarks import (
        HEADLINE,
        build_headline_sim,
        require_gpu,
        time_sim_steps,
    )
    from informationbottleneckdecodingldpc_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    device = require_gpu()
    sim = build_headline_sim()
    reps = int(os.environ.get("BENCH_REPS", "6"))
    t = time_sim_steps(sim, HEADLINE["ebn0_db"], dispatches=reps)
    print(
        json.dumps(
            {
                "metric": "wlan_ib_lut_decode_coded_throughput",
                "value": t["coded_bits_per_s"] / 1e6,
                "unit": "Mbit/s/card",
                "device": device,
                "step_s": t["step_s"],
                "compile_s": t["compile_s"],
                "batch": HEADLINE["batch"],
                "steps_per_dispatch": HEADLINE["steps_per_dispatch"],
                "ebn0_db": HEADLINE["ebn0_db"],
            }
        )
    )


if __name__ == "__main__":
    main()
