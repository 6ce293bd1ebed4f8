import numpy as np
import pytest

import jax

from informationbottleneckdecodingldpc_tpu.codes import TannerGraph, regular_parity_check
from informationbottleneckdecodingldpc_tpu.construct import build_decoder_config
from informationbottleneckdecodingldpc_tpu.decode import DecodeLayout, DeviceTrellis
from informationbottleneckdecodingldpc_tpu.sim import (
    BERSimulator,
    SweepController,
    SweepSchedule,
    load_results,
    save_results,
)


@pytest.fixture(scope="module")
def small_setup():
    H = regular_parity_check(96, 3, 6, seed=7)
    layout = DecodeLayout.from_graph(TannerGraph.from_check_matrix(H))
    cfg = build_decoder_config(
        design_ebn0_db=2.5,
        cardinality_y_channel=400,
        cardinality_t_channel=16,
        cardinality_t_decoder=16,
        i_max=8,
        d_v=3,
        d_c=6,
    )
    return layout, DeviceTrellis.from_tables(cfg.tables)


def test_minsum_point_runs(small_setup):
    layout, _ = small_setup
    sim = BERSimulator(
        layout, "minsum", max_iters=8, chain="allzero",
        count_all_bits=True, batch_per_device=16, n_devices=1, seed=1,
    )
    res = sim.run_point(3.0, min_errors=50, max_blocks=5000)
    assert res.errors >= 50 or res.blocks >= 5000
    assert 0 < res.ber < 0.2
    assert res.coded_bits_per_s > 0


def test_ib_point_runs(small_setup):
    layout, trellis = small_setup
    sim = BERSimulator(
        layout, "ib", trellis=trellis, chain="allzero",
        count_all_bits=True, batch_per_device=16, n_devices=1, seed=1,
    )
    res = sim.run_point(2.5, min_errors=30, max_blocks=5000)
    assert res.errors >= 30 or res.blocks >= 5000
    assert 0 < res.ber < 0.2


@pytest.fixture(scope="module")
def encoded_setup():
    """A small regular (3,6) code whose parity part is invertible, so the
    encoded chain can run on it."""
    from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder

    H = regular_parity_check(96, 3, 6, seed=10)
    return DecodeLayout.from_graph(TannerGraph.from_check_matrix(H)), LDPCEncoder(H)


@pytest.mark.parametrize("chain", ["allzero", "encoded"])
@pytest.mark.parametrize("decoder", ["ib", "minsum", "bp"])
def test_mesh_shape_invariance_exact(small_setup, encoded_setup, decoder, chain):
    """Same seed => bitwise-identical error counters regardless of how the
    global batch is split over the mesh (SURVEY.md §4.5). Per-codeword RNG
    keys are derived from the global codeword index, so 8x4, 2x16 and 1x32
    decode exactly the same codewords, and the psum'd early-exit test runs
    them for the same number of iterations."""
    layout, trellis = small_setup
    assert len(jax.devices()) >= 8
    kw = dict(chain=chain, count_all_bits=chain == "allzero", seed=3)
    if chain == "encoded":
        layout, kw["encoder"] = encoded_setup
    if decoder == "ib":
        kw["trellis"] = trellis
    else:
        kw["max_iters"] = 8
    runs = {}
    for n_dev, per_dev in [(8, 4), (2, 16), (1, 32)]:
        sim = BERSimulator(
            layout, decoder, batch_per_device=per_dev, n_devices=n_dev, **kw
        )
        runs[n_dev] = sim.run_point(2.5, min_errors=20, max_blocks=640)
    ref = runs[1]
    assert ref.errors > 0
    for n_dev in (2, 8):
        assert runs[n_dev].blocks == ref.blocks
        assert runs[n_dev].errors == ref.errors, f"mesh {n_dev}x differs"
        assert runs[n_dev].frame_errors == ref.frame_errors
        assert runs[n_dev].mean_iterations == ref.mean_iterations


def test_sweep_persists_and_resumes(small_setup, tmp_path):
    layout, _ = small_setup
    sim = BERSimulator(
        layout, "minsum", max_iters=8, chain="allzero",
        count_all_bits=True, batch_per_device=16, n_devices=1, seed=5,
    )
    path = str(tmp_path / "sweep.json")
    sched = SweepSchedule(
        start_db=2.0, normal_step_db=0.5, max_db=2.5, target_ber=1e-9,
        min_errors=20, max_blocks_per_point=320,
    )
    ctrl = SweepController(sim, sched, results_path=path, verbose=False)
    results = ctrl.run()
    assert len(results) >= 2
    saved = load_results(path)
    assert [r.ebn0_db for r in saved] == [r.ebn0_db for r in results]
    # Resume is a no-op when the sweep is complete.
    results2 = SweepController(sim, sched, results_path=path, verbose=False).run()
    assert [r.ebn0_db for r in results2] == [r.ebn0_db for r in results]


def test_encoded_chain_matches_allzero_statistics():
    """Encoded chain BER agrees with the all-zeros direct path within MC
    error (the linearity argument the reference's fast path relies on,
    SURVEY.md §3.3)."""
    from informationbottleneckdecodingldpc_tpu.encode import LDPCEncoder
    from informationbottleneckdecodingldpc_tpu.codes import dvbs2_like_parity_check

    H = dvbs2_like_parity_check(1920, 960, seed=9)
    g = TannerGraph.from_check_matrix(H)
    layout = DecodeLayout.from_graph(g)
    enc = LDPCEncoder(H)
    common = dict(
        max_iters=12, count_all_bits=False, batch_per_device=16,
        n_devices=1, seed=11,
    )
    sim_enc = BERSimulator(layout, "minsum", chain="encoded", encoder=enc, **common)
    sim_zero = BERSimulator(layout, "minsum", chain="allzero", **common)
    r_enc = sim_enc.run_point(2.2, min_errors=300, max_blocks=3000)
    r_zero = sim_zero.run_point(2.2, min_errors=300, max_blocks=3000)
    assert r_enc.ber > 0 and r_zero.ber > 0
    assert abs(np.log10(r_enc.ber) - np.log10(r_zero.ber)) < 0.5


def test_midpoint_checkpoint_resume_exact(small_setup, tmp_path):
    """Interrupting a point mid-way and resuming from the persisted partial
    state reproduces the uninterrupted run's counters exactly (same RNG
    stream positions)."""
    from informationbottleneckdecodingldpc_tpu.sim.engine import PointCheckpoint
    from informationbottleneckdecodingldpc_tpu.sim.results import (
        load_partial,
        save_results,
    )
    import dataclasses as dc

    layout, trellis = small_setup
    mk = lambda: BERSimulator(
        layout, "ib", trellis=trellis, chain="allzero",
        count_all_bits=True, batch_per_device=16, n_devices=1, seed=3,
    )

    full = mk().run_point(1.0, min_errors=300, max_blocks=20000)

    # Interrupted run: stop after 2 steps by snapshotting the state then
    # resuming from it with a fresh simulator.
    snap = {}

    class Stop(Exception):
        pass

    def grab(state):
        snap.update(dc.asdict(state))
        if state.step_index >= 2:
            raise Stop

    sim2 = mk()
    try:
        sim2.run_point(1.0, min_errors=300, max_blocks=20000, on_progress=grab)
    except Stop:
        pass
    path = str(tmp_path / "res.json")
    save_results(path, [], partial=snap)

    resumed = mk().run_point(
        1.0, min_errors=300, max_blocks=20000,
        checkpoint=PointCheckpoint(**load_partial(path)),
    )
    assert resumed.errors == full.errors
    assert resumed.blocks == full.blocks
    assert resumed.frame_errors == full.frame_errors


def test_multihost_flag_single_process(tmp_path):
    """--multihost wires jax.distributed.initialize and still produces a
    result file (1-process cluster on CPU; run in a subprocess because the
    distributed client is process-global)."""
    import subprocess, sys, os, json, socket

    res = str(tmp_path / "mh.json")
    # A fixed coordinator port can collide with a concurrent test run and
    # hang initialize() until the outer timeout — pick a free one.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=os.path.join(
            os.path.dirname(os.path.dirname(__file__)), ".jax_cache_tests"
        ),
    )
    out = subprocess.run(
        [sys.executable, "-m", "informationbottleneckdecodingldpc_tpu.cli.simulate",
         "--model", "regular-3-6-504", "--decoder", "minsum", "--chain", "allzero",
         "--start-db", "3.0", "--max-db", "3.0", "--min-errors", "5",
         "--max-iters", "4", "--batch-per-device", "8",
         "--max-blocks-per-point", "64", "--results", res,
         "--multihost", "--coordinator-address", f"localhost:{port}",
         "--num-processes", "1", "--process-id", "0"],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "multihost: process 0/1" in out.stdout
    points = json.load(open(res))["points"]
    assert len(points) == 1 and points[0]["blocks"] > 0


def test_steps_per_dispatch_counter_invariance(small_setup):
    """Scanning K steps per dispatch must accumulate exactly the same
    counters as K separate dispatches (same fold_in(root, absolute_step)
    stream)."""
    layout, trellis = small_setup
    mk = lambda k: BERSimulator(
        layout, "ib", trellis=trellis, chain="allzero", count_all_bits=True,
        batch_per_device=16, n_devices=1, seed=9, steps_per_dispatch=k,
    )
    # 128 blocks divides both dispatch sizes (16 and 64), so neither run
    # overshoots max_blocks.
    r1 = mk(1).run_point(2.0, min_errors=10**9, max_blocks=128)
    r4 = mk(4).run_point(2.0, min_errors=10**9, max_blocks=128)
    assert r1.blocks == r4.blocks == 128
    assert r1.errors == r4.errors
    assert r1.frame_errors == r4.frame_errors


def test_multihost_two_process_resume_broadcast(tmp_path):
    """Genuine 2-process jax.distributed run of the sweep-resume broadcast
    (sim/sweep.py resume_state): process 0 holds a completed 1-point results
    file, process 1 starts with none; the resumed 2-process sweep must (a)
    broadcast process 0's state, (b) append exactly the remaining point, and
    (c) produce counters identical to a single-process run of the same
    global schedule (mesh-shape-invariant RNG)."""
    import subprocess, sys, os, json, socket

    cache = os.path.join(
        os.path.dirname(os.path.dirname(__file__)), ".jax_cache_tests"
    )
    base_env = dict(os.environ, JAX_PLATFORMS="cpu",
                    JAX_COMPILATION_CACHE_DIR=cache)

    def cli(results, extra, xla_devices, timeout=900):
        env = dict(
            base_env,
            XLA_FLAGS=f"--xla_force_host_platform_device_count={xla_devices}",
        )
        return subprocess.run(
            [sys.executable, "-m",
             "informationbottleneckdecodingldpc_tpu.cli.simulate",
             "--model", "regular-3-6-504", "--decoder", "minsum",
             "--chain", "allzero", "--start-db", "3.0", "--min-errors", "5",
             "--max-iters", "4", "--batch-per-device", "8",
             "--max-blocks-per-point", "64", "--results", results] + extra,
            capture_output=True, text=True, env=env, timeout=timeout,
        )

    # Phase 1 (single process, 8 virtual devices): one completed point.
    res0 = str(tmp_path / "mh2.json")
    out = cli(res0, ["--max-db", "3.0"], 8)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(json.load(open(res0))["points"]) == 1

    # Reference: full 2-point sweep, single process, same global batch.
    res_ref = str(tmp_path / "ref.json")
    out = cli(res_ref, ["--max-db", "3.1"], 8)
    assert out.returncode == 0, out.stderr[-2000:]
    ref_points = json.load(open(res_ref))["points"]
    assert len(ref_points) == 2

    # Phase 2: resume with 2 processes x 4 devices. Process 1 gets a
    # results path that does NOT exist — it can only resume via the
    # broadcast of process 0's state.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mh = ["--multihost", "--coordinator-address", f"localhost:{port}",
          "--num-processes", "2", "--max-db", "3.1"]
    env = dict(base_env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "informationbottleneckdecodingldpc_tpu.cli.simulate",
             "--model", "regular-3-6-504", "--decoder", "minsum",
             "--chain", "allzero", "--start-db", "3.0", "--min-errors", "5",
             "--max-iters", "4", "--batch-per-device", "8",
             "--max-blocks-per-point", "64",
             "--results", res0 if pid == 0 else str(tmp_path / "absent.json")]
            + mh + ["--process-id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert "multihost: process 0/2" in outs[0][0]
    assert "multihost: process 1/2" in outs[1][0]
    # BOTH processes resume from the broadcast state (process 1 has no
    # results file of its own).
    for so, _ in outs:
        assert "resuming sweep from broadcast state: 1 completed points" in so
    # Process 1 never wrote its (absent) results path.
    assert not os.path.exists(str(tmp_path / "absent.json"))

    got_points = json.load(open(res0))["points"]
    assert len(got_points) == 2
    for got, ref in zip(got_points, ref_points):
        assert got["errors"] == ref["errors"], (got, ref)
        assert got["frame_errors"] == ref["frame_errors"]
        assert got["blocks"] == ref["blocks"]
