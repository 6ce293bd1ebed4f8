"""Run a BER simulation sweep.

Equivalent of the reference's ``BER_simulation_OpenCL*.py`` scripts, unified:
decoder choice (ib | minsum | bp), chain (allzero | encoded), resumable
results, optional .npz/.mat export.

Usage:
  python -m informationbottleneckdecodingldpc_tpu.cli.simulate \
      --model wlan-1296 --decoder ib --config wlan_0.8.npz \
      --results wlan_ib.json --max-db 2.0
"""

from __future__ import annotations

import argparse

from ..codes import TannerGraph
from ..construct import DecoderConfig
from ..decode import DecodeLayout, DeviceTrellis
from ..encode import LDPCEncoder
from ..models import get_model
from ..utils.compile_cache import enable_compile_cache
from ..sim import BERSimulator, SweepController, SweepSchedule
from ..sim.results import export_mat, export_npz, export_plot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--decoder", choices=["ib", "minsum", "bp"], default="ib")
    p.add_argument("--config", default=None, help="decoder config .npz (ib)")
    p.add_argument("--chain", choices=["allzero", "encoded"], default="allzero")
    p.add_argument("--llr-source", choices=["quantized", "true"], default="quantized")
    p.add_argument("--modulation", default="bpsk",
                   help="bpsk (default) | qam<M> | psk<M>, e.g. qam16, psk8; "
                        "M-ary runs the encoded chain into a float decoder "
                        "via the exact soft demapper (implies "
                        "--llr-source true)")
    p.add_argument("--start-db", type=float, default=0.0)
    p.add_argument("--max-db", type=float, default=None)
    p.add_argument("--step-db", type=float, default=0.1)
    p.add_argument("--target-ber", type=float, default=1e-6)
    p.add_argument("--min-errors", type=int, default=None)
    p.add_argument("--max-blocks-per-point", type=int, default=None,
                   help="cap Monte-Carlo blocks per SNR point")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--t-channel", type=int, default=None,
                   help="channel-quantizer cardinality |T_ch| for float "
                        "decoders (the reference's argv mode, DVB-S2 "
                        "BER_simulation_OpenCL_min_sum.py:49-50; default: "
                        "model spec / decoder config)")
    p.add_argument("--batch-per-device", type=int, default=None)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="Monte-Carlo steps scanned per device dispatch "
                        "(amortizes dispatch latency; counters unchanged)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="default: all visible devices")
    p.add_argument("--no-early-exit", action="store_true")
    p.add_argument("--results", required=True, help="JSON results (resume point)")
    p.add_argument("--export-npz", default=None)
    p.add_argument("--export-mat", default=None)
    p.add_argument("--export-plot", default=None, help="BER curve (pdf/png)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace (TensorBoard/XProf)")
    p.add_argument("--multihost", action="store_true",
                   help="join the multi-process JAX runtime before building "
                        "the mesh (jax.distributed.initialize; topology from "
                        "the cluster env or the flags below)")
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    enable_compile_cache()

    results_path = args.results
    is_primary = True
    resume_state = None
    if args.multihost:
        from ..parallel.mesh import initialize_multihost

        proc, nprocs = initialize_multihost(
            args.coordinator_address, args.num_processes, args.process_id
        )
        print(f"multihost: process {proc}/{nprocs}", flush=True)
        is_primary = proc == 0
        if nprocs > 1:
            # All processes must replay the identical sweep (every jitted
            # step issues collectives), so process 0's resume state — the
            # persisted points and mid-point checkpoint — is broadcast and
            # used by everyone; only process 0 writes results/exports.
            resume_state = _broadcast_resume_state(results_path, is_primary)

    spec = get_model(args.model)
    H = spec.make_h()
    layout = spec.make_layout()

    trellis = None
    cardinality_t_channel = spec.cardinality_t_channel
    if args.decoder == "ib":
        if not args.config:
            p.error("--config is required for the ib decoder")
        cfg = DecoderConfig.load(args.config)
        trellis = DeviceTrellis.from_tables(cfg.tables)
        cardinality_t_channel = cfg.tables.cardinality_t_channel
    if args.t_channel is not None:
        if args.decoder == "ib":
            p.error("--t-channel applies to float decoders only (the ib "
                    "decoder's |T_ch| comes from its config)")
        cardinality_t_channel = args.t_channel

    encoder = LDPCEncoder(H) if args.chain == "encoded" else None

    modulation, mod_order, llr_source = "bpsk", 2, args.llr_source
    if args.modulation != "bpsk":
        import math
        import re

        m = re.fullmatch(r"(qam|psk)(\d+)", args.modulation)
        if not m:
            p.error(f"unrecognized --modulation {args.modulation!r}")
        M = int(m.group(2))
        if M < 4 or (M & (M - 1)):
            p.error("modulation order must be a power of two >= 4")
        if m.group(1) == "qam":
            sqrt_m = math.isqrt(M)
            if sqrt_m * sqrt_m != M:
                p.error("qam order must be a perfect square (square QAM)")
            modulation, mod_order = "qam", sqrt_m
        else:
            modulation, mod_order = "mpsk", M
        llr_source = "true"

    sim = BERSimulator(
        layout,
        args.decoder,
        trellis=trellis,
        max_iters=args.max_iters or spec.decode_i_max,
        chain=args.chain,
        llr_source=llr_source,
        modulation=modulation,
        mod_order=mod_order,
        count_all_bits=spec.count_all_bits and args.chain == "allzero",
        cardinality_t_channel=cardinality_t_channel,
        batch_per_device=args.batch_per_device or spec.batch_hint,
        n_devices=args.n_devices,
        early_exit=not args.no_early_exit,
        encoder=encoder,
        seed=args.seed,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    sched = SweepSchedule(
        start_db=args.start_db,
        normal_step_db=args.step_db,
        max_db=args.max_db if args.max_db is not None else spec.sweep_max_db,
        target_ber=args.target_ber,
        min_errors=args.min_errors or spec.min_errors,
        **(
            {"max_blocks_per_point": args.max_blocks_per_point}
            if args.max_blocks_per_point
            else {}
        ),
    )
    from ..utils.profiling import device_trace

    with device_trace(args.trace_dir):
        results = SweepController(
            sim,
            sched,
            results_path=results_path,
            write_results=is_primary,
            resume_state=resume_state,
        ).run()
    if is_primary:
        if args.export_npz:
            export_npz(args.export_npz, results)
        if args.export_mat:
            export_mat(args.export_mat, results, decoder_name=args.model)
        if args.export_plot:
            export_plot(args.export_plot, results, label=f"{args.model}/{args.decoder}")


def _broadcast_resume_state(results_path: str, is_primary: bool) -> dict:
    """Ship process 0's persisted sweep state to every process.

    JSON payload as length-prefixed uint8 via two broadcast_one_to_all calls
    (shapes must agree on all processes, so the length goes first).
    """
    import json
    import os

    import numpy as np
    from jax.experimental import multihost_utils

    payload = b"{}"
    if is_primary and os.path.exists(results_path):
        with open(results_path, "rb") as f:
            payload = f.read()
    n = int(multihost_utils.broadcast_one_to_all(np.int64(len(payload))))
    buf = np.frombuffer(payload.ljust(n, b" "), dtype=np.uint8)
    if not is_primary:
        buf = np.zeros(n, dtype=np.uint8)
    buf = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return json.loads(bytes(buf).decode())


if __name__ == "__main__":
    main()
