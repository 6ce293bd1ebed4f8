"""Component timing of the DVB-S2 N=64800 decode step on the accelerator.

Separates per-iteration decode cost into routing (to_vn/to_cn moves) vs node
folds vs chain overhead (encode/quantize/RNG), to target the next
optimization. Run with the device otherwise idle.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main(batch=128):
    from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig
    from informationbottleneckdecodingldpc_tpu.decode import (
        DeviceTrellis,
        ib_lut_decode,
    )
    from informationbottleneckdecodingldpc_tpu.models import get_model
    from informationbottleneckdecodingldpc_tpu.utils.compile_cache import (
        REPO_ROOT,
        enable_compile_cache,
    )

    enable_compile_cache()

    spec = get_model("dvbs2-64800")
    layout = spec.make_layout()
    cfg = DecoderConfig.load(
        os.path.join(REPO_ROOT, "results", "configs", "dvbs2_T16_0.6.npz")
    )
    trellis = DeviceTrellis.from_tables(cfg.tables)
    rng = np.random.default_rng(0)
    ch = jnp.asarray(rng.integers(0, 16, (layout.n_vars, batch)), jnp.int32)
    x = jnp.asarray(rng.integers(0, 16, (layout.n_edges, batch)), jnp.int32)

    # 1) decode per-iteration cost
    d1 = timed(jax.jit(lambda c: ib_lut_decode(layout, trellis, c, max_iters=1, early_exit=False).outputs), ch)
    d11 = timed(jax.jit(lambda c: ib_lut_decode(layout, trellis, c, max_iters=11, early_exit=False).outputs), ch)
    per_iter = (d11 - d1) / 10
    print(f"decode imax=1: {d1*1e3:.1f} ms;  per extra iteration: {per_iter*1e3:.2f} ms")

    # 2) routing alone: K round trips through both permutations
    K = 20

    @jax.jit
    def route(x):
        def body(v, _):
            return layout.to_cn.apply(layout.to_vn.apply(v)), None
        v, _ = jax.lax.scan(body, x, None, length=K)
        return v

    r = timed(route, x) / K
    print(f"routing (to_vn + to_cn): {r*1e3:.2f} ms/iter "
          f"({2*layout.n_edges*batch*4/ r / 1e9:.1f} GB/s effective)")

    # 3) syndrome alone
    from informationbottleneckdecodingldpc_tpu.decode.common import unsatisfied_checks

    @jax.jit
    def synd(x):
        def body(c, _):
            return c + jnp.sum(unsatisfied_checks(layout, x < 8)), None
        c, _ = jax.lax.scan(body, jnp.int32(0), None, length=K)
        return c

    s = timed(synd, x) / K
    print(f"syndrome: {s*1e3:.2f} ms/iter")

    folds = per_iter - r - s
    print(f"=> node folds + table slicing: {folds*1e3:.2f} ms/iter")
    coded = layout.n_vars * batch
    print(f"implied full-decode throughput at 50 iters: "
          f"{coded / (50*per_iter) / 1e6:.2f} Mbit/s coded")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128)
