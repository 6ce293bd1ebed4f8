"""Entry-point plumbing that runs on the CPU: the compile-cache location,
the GPU gate of the measurement surfaces, chip_smoke's comparison rule and
the trace reduction's busy time."""

import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from informationbottleneckdecodingldpc_tpu.utils import compile_cache
from informationbottleneckdecodingldpc_tpu.utils.benchmarks import require_gpu
from informationbottleneckdecodingldpc_tpu.utils.profiling import busy_ns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu_only_process():
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_chip_smoke_fails_without_gpu():
    """No card: a non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _point(errors, frame_errors, blocks=1000, bits=1_000_000):
    return SimpleNamespace(
        errors=errors, frame_errors=frame_errors, blocks=blocks,
        bits_counted=bits, ber=errors / bits, fer=frame_errors / blocks,
    )


@pytest.mark.parametrize(
    "gpu_counts,exact,passes",
    [
        ((500, 100), True, True),     # identical counters
        ((510, 102), False, True),    # inside the CPU run's 95% interval
        ((510, 102), True, False),    # any difference fails an exact phase
        ((700, 100), False, False),   # BER outside the interval
    ],
    ids=["identical", "inside", "exact", "outside"],
)
def test_chip_smoke_counter_comparison(gpu_counts, exact, passes):
    cs = _chip_smoke()
    gpu, cpu = _point(*gpu_counts), _point(500, 100)
    if passes:
        cs.compare("t", gpu, cpu, exact)
    else:
        with pytest.raises(SystemExit):
            cs.compare("t", gpu, cpu, exact)


@pytest.mark.parametrize(
    "intervals,busy",
    [
        ([], 0.0),
        ([(0, 10), (20, 30)], 20.0),             # disjoint
        ([(0, 10), (5, 15), (25, 26)], 16.0),    # overlapping
        ([(20, 30), (0, 100), (40, 50)], 100.0),  # nested, unsorted
    ],
    ids=["empty", "disjoint", "overlapping", "nested"],
)
def test_trace_busy_time_is_interval_union(intervals, busy):
    assert busy_ns(intervals) == busy
