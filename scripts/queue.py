"""One parameterized pipeline for the whole results/ tree (round-2 verdict #7).

Stages (all idempotent / resumable — rerunning skips finished work):

  configs  - build every decoder-config artifact that is missing
  sweeps   - run every BER parity sweep (sequential: one accelerator);
             each sweep resumes from its results JSON
  extend   - reopen specific completed points to accumulate more errors
             (tail statistics, round-2 verdict #3): converts the completed
             point back into the engine's mid-point checkpoint — exact
             continuation since per-codeword RNG keys depend only on
             (seed, absolute step index)
  bench    - scripts/bench_matrix.py (throughput matrix)
  report   - scripts/make_parity_report.py (PARITY.md)

Usage:
  python scripts/queue.py                      # everything
  python scripts/queue.py --stages sweeps --only regular_ib_sib105
  python scripts/queue.py --list
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
CFG_DIR = "artifacts/configs"
LOG_DIR = "artifacts/logs"


# --------------------------------------------------------------------------
# Declarative work lists

CONFIGS = [
    # (output name, construct-CLI args)
    ("wlan_T16_0.8", "--model wlan-1296 --ebn0 0.8"),
    ("wlan_T32_0.6", "--model wlan-1296-T32 --ebn0 0.6"),
    ("regular_T16_1.05", "--model regular-3-6-8000 --ebn0 1.05"),
    ("regular_T16_1.25", "--model regular-3-6-8000 --ebn0 1.25"),
    ("dvbs2_T16_0.6", "--model dvbs2-64800 --ebn0 0.6"),
    ("dvbs2_T16_0.8", "--model dvbs2-64800 --ebn0 0.8"),
    # Randomized-sIB construction stack (the reference's lin_sym_sIB with
    # nror=10) at the published near-threshold design points — built to
    # resolve whether the DE stall there is a DP artifact (verdict #2).
    ("regular_T16_1.05_sib", "--model regular-3-6-8000 --ebn0 1.05 --ib-backend sib --nror 10"),
    ("dvbs2_T16_0.6_sib", "--model dvbs2-64800 --ebn0 0.6 --ib-backend sib --nror 10"),
]


@dataclasses.dataclass
class Sweep:
    name: str
    args: str  # simulate-CLI args (results/export paths added automatically)

    @property
    def results(self):
        return f"results/ber/{self.name}.json"

    def cmd(self, extra=""):
        return (
            f"{PY} -m informationbottleneckdecodingldpc_tpu.cli.simulate "
            f"{self.args} {extra} --results {self.results} "
            f"--export-npz results/ber/{self.name}.npz "
            f"--export-plot results/ber/{self.name}.png"
        )


SWEEPS = [
    # Reference operating points: BASELINE.md:20-29 / SURVEY.md §6.
    Sweep("wlan_ib_T16_enc",
          f"--model wlan-1296 --decoder ib --config {CFG_DIR}/wlan_T16_0.8.npz "
          "--chain encoded --start-db 0.6 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 20"),
    Sweep("wlan_minsum_enc",
          "--model wlan-1296 --decoder minsum --chain encoded --start-db 0.6 "
          "--min-errors 7000 --batch-per-device 512 --steps-per-dispatch 8 --seed 21"),
    Sweep("wlan_bp_enc",
          "--model wlan-1296 --decoder bp --chain encoded --start-db 0.6 "
          "--min-errors 7000 --batch-per-device 512 --steps-per-dispatch 8 --seed 22"),
    Sweep("regular_ib_allzero",
          f"--model regular-3-6-8000 --decoder ib --config {CFG_DIR}/regular_T16_1.05.npz "
          "--chain allzero --start-db 0.5 --min-errors 7000 "
          "--batch-per-device 256 --steps-per-dispatch 4 --seed 23"),
    Sweep("regular_ib_d125",
          f"--model regular-3-6-8000 --decoder ib --config {CFG_DIR}/regular_T16_1.25.npz "
          "--chain allzero --start-db 0.8 --min-errors 7000 "
          "--batch-per-device 256 --steps-per-dispatch 4 --seed 29"),
    Sweep("regular_ib_sib105",
          f"--model regular-3-6-8000 --decoder ib --config {CFG_DIR}/regular_T16_1.05_sib.npz "
          "--chain allzero --start-db 0.5 --min-errors 7000 "
          "--batch-per-device 256 --steps-per-dispatch 4 --seed 31"),
    Sweep("wlan_ib_T32_enc",
          f"--model wlan-1296-T32 --decoder ib --config {CFG_DIR}/wlan_T32_0.6.npz "
          "--chain encoded --start-db 0.6 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 24"),
    Sweep("regular_minsum",
          "--model regular-3-6-8000 --decoder minsum --chain allzero --start-db 0.5 "
          "--max-iters 50 --min-errors 7000 --batch-per-device 256 "
          "--steps-per-dispatch 4 --seed 26"),
    Sweep("dvbs2_ib_enc",
          f"--model dvbs2-64800 --decoder ib --config {CFG_DIR}/dvbs2_T16_0.6.npz "
          "--chain encoded --start-db 0.6 --max-db 1.3 --min-errors 5000 "
          "--target-ber 1e-5 --max-blocks-per-point 200000 "
          "--batch-per-device 128 --seed 25"),
    Sweep("dvbs2_ib_enc_d08",
          f"--model dvbs2-64800 --decoder ib --config {CFG_DIR}/dvbs2_T16_0.8.npz "
          "--chain encoded --start-db 0.8 --max-db 1.3 --min-errors 5000 "
          "--target-ber 1e-7 --max-blocks-per-point 200000 "
          "--batch-per-device 128 --seed 28"),
    Sweep("dvbs2_minsum",
          "--model dvbs2-64800 --decoder minsum --chain allzero --start-db 0.6 "
          "--max-db 1.3 --min-errors 5000 --target-ber 1e-5 "
          "--max-blocks-per-point 200000 --batch-per-device 128 --seed 27"),
    # The reference's argv |T|=32 min-sum mode
    # (DVB-S2/BER_simulation_OpenCL_min_sum.py:49-50).
    Sweep("dvbs2_minsum_T32",
          "--model dvbs2-64800 --decoder minsum --t-channel 32 "
          "--chain allzero --start-db 0.6 "
          "--max-db 1.3 --min-errors 5000 --target-ber 1e-5 "
          "--max-blocks-per-point 200000 --batch-per-device 128 --seed 34"),
    # M-ary chain (round-2 verdict #8): 16-QAM through the exact soft
    # demapper into min-sum — the end-to-end path the reference intended but
    # left broken (AWGN_Quantizer_Mary absent). Eb/N0 axis, so the curve is
    # directly comparable against the BPSK min-sum benchmark.
    Sweep("wlan_minsum_qam16",
          "--model wlan-1296 --decoder minsum --chain encoded "
          "--modulation qam16 --start-db 1.0 --max-db 4.5 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 33"),
    # 8-PSK chain (round-3 verdict #8): the reference's LDPC_MPSK_Transmitter
    # (AWGN_Channel_Transmission/LDPC_Transmitter.py:177) as a committed
    # end-to-end curve, through the exact PSK soft demapper into min-sum.
    Sweep("wlan_minsum_psk8",
          "--model wlan-1296 --decoder minsum --chain encoded "
          "--modulation psk8 --start-db 1.5 --max-db 5.0 --min-errors 7000 "
          "--batch-per-device 512 --steps-per-dispatch 8 --seed 34"),
]


@dataclasses.dataclass
class Extension:
    """Reopen sweep's completed point at ``ebn0_db`` until ``min_errors`` or
    ``max_blocks`` (whichever first). ``batch`` must match the sweep's
    original batch_per_device * n_devices (step index = blocks / batch)."""

    sweep: str
    ebn0_db: float
    min_errors: int
    max_blocks: int
    batch: int


EXTENSIONS = [
    # Round-2 verdict #3: thin tails. 136 errors @1.1 dB (+-17% at 1 sigma)
    # and 3521 @2.4 dB vs the reference's 5000-7000 stopping rule.
    Extension("dvbs2_ib_enc_d08", 1.1, 1000, 1_500_000, 128),
    Extension("wlan_ib_T16_enc", 2.4, 7000, 30_000_000, 512),
    Extension("wlan_ib_T32_enc", 2.3, 7000, 30_000_000, 512),
]


# --------------------------------------------------------------------------


def sh(cmd, log=None):
    print(f"[{time.strftime('%H:%M:%S')}] $ {cmd}" + (f" > {log}" if log else ""),
          flush=True)
    if log:
        with open(log, "a") as f:
            return subprocess.call(cmd, shell=True, stdout=f, stderr=f, cwd=ROOT)
    return subprocess.call(cmd, shell=True, cwd=ROOT)


def stage_configs(only):
    for name, args in CONFIGS:
        if only and name not in only:
            continue
        out = f"{CFG_DIR}/{name}.npz"
        if os.path.exists(out):
            print(f"config {name}: exists", flush=True)
            continue
        rc = sh(
            f"JAX_PLATFORMS=cpu {PY} -m informationbottleneckdecodingldpc_tpu."
            f"cli.construct {args} --output {out} "
            f"--export-exit-chart {CFG_DIR}/{name}_exit.png --verbose",
            log=f"{LOG_DIR}/config_{name}.log",
        )
        print(f"config {name}: {'done' if rc == 0 else 'FAILED'}", flush=True)


def stage_sweeps(only):
    for s in SWEEPS:
        if only and s.name not in only:
            continue
        rc = sh(s.cmd(), log=f"{LOG_DIR}/sweep_{s.name}.log")
        print(f"sweep {s.name}: {'done' if rc == 0 else 'FAILED'}", flush=True)


def reopen_point(results_path, ebn0_db, batch):
    """Convert the completed point at ebn0_db back into a partial checkpoint."""
    with open(results_path) as f:
        payload = json.load(f)
    pts = payload["points"]
    idx = next(
        (i for i, p in enumerate(pts) if abs(p["ebn0_db"] - ebn0_db) < 1e-9), None
    )
    if idx is None:
        return False
    p = pts.pop(idx)
    if any(q["ebn0_db"] > ebn0_db for q in pts):
        raise SystemExit(
            f"{results_path}: cannot reopen {ebn0_db} dB — later points exist"
        )
    assert p["blocks"] % batch == 0, "batch must match the original sweep"
    payload["partial"] = dict(
        ebn0_db=p["ebn0_db"],
        step_index=p["blocks"] // batch,
        errors=p["errors"],
        frame_errors=p["frame_errors"],
        blocks=p["blocks"],
        iters_sum=p["mean_iterations"] * p["blocks"],
    )
    tmp = results_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, results_path)
    return True


def stage_extend(only):
    by_name = {s.name: s for s in SWEEPS}
    for e in EXTENSIONS:
        if only and e.sweep not in only:
            continue
        s = by_name[e.sweep]
        with open(s.results) as f:
            pts = json.load(f)["points"]
        cur = next(
            (p for p in pts if abs(p["ebn0_db"] - e.ebn0_db) < 1e-9), None
        )
        if cur is None:
            print(f"extend {e.sweep}@{e.ebn0_db}: point is already open/absent",
                  flush=True)
        elif cur["errors"] >= e.min_errors or cur["blocks"] >= e.max_blocks:
            print(f"extend {e.sweep}@{e.ebn0_db}: already at "
                  f"{cur['errors']} errors / {cur['blocks']} blocks", flush=True)
            continue
        else:
            reopen_point(s.results, e.ebn0_db, e.batch)
        rc = sh(
            s.cmd(
                f"--min-errors {e.min_errors} "
                f"--max-blocks-per-point {e.max_blocks}"
            ),
            log=f"{LOG_DIR}/extend_{e.sweep}.log",
        )
        print(f"extend {e.sweep}@{e.ebn0_db}: {'done' if rc == 0 else 'FAILED'}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", default="configs,sweeps,extend,bench,report")
    ap.add_argument("--only", default=None,
                    help="comma-separated config/sweep names to restrict to")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        print("configs:", *(n for n, _ in CONFIGS), sep="\n  ")
        print("sweeps:", *(s.name for s in SWEEPS), sep="\n  ")
        print("extensions:",
              *(f"{e.sweep}@{e.ebn0_db} -> {e.min_errors} errors" for e in EXTENSIONS),
              sep="\n  ")
        return
    os.chdir(ROOT)
    os.makedirs(CFG_DIR, exist_ok=True)
    os.makedirs(LOG_DIR, exist_ok=True)
    os.makedirs("results/ber", exist_ok=True)
    only = set(args.only.split(",")) if args.only else None
    stages = args.stages.split(",")
    # Stages are independent: a crash in one (e.g. a bench failure) must not
    # suppress the later ones — round-3 verdict #3: PARITY.md went stale
    # because a bench crash stopped the queue before the report stage.
    failures = []

    def guarded(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - keep the queue running
            print(f"stage {name} FAILED: {e!r}", flush=True)
            failures.append(name)

    if "configs" in stages:
        guarded("configs", lambda: stage_configs(only))
    if "sweeps" in stages:
        guarded("sweeps", lambda: stage_sweeps(only))
    if "extend" in stages:
        guarded("extend", lambda: stage_extend(only))
    if "bench" in stages:
        guarded("bench", lambda: sh(
            f"{PY} scripts/bench_matrix.py --out artifacts/bench_matrix.json", log=f"{LOG_DIR}/bench_matrix.log"
        ))
    if "report" in stages:
        guarded("report", lambda: sh(f"{PY} scripts/make_parity_report.py"))
    if failures:
        raise SystemExit(f"failed stages: {','.join(failures)}")


if __name__ == "__main__":
    main()
