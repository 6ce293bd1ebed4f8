"""Micro-benchmark the pieces of one IB LUT decode on the accelerator.

Times, with ``block_until_ready``, for each requested lookup lowering
(``ops/lut_fold.set_lookup_mode``): one check-node pass, one variable-node
pass, the syndrome, and the full fixed-iteration decode; and, once, each
CN<->VN message move as the run-decomposed plan (``PermutationPlan.apply``)
against a single row gather (``jnp.take``). With ``--trace-dir`` it also
records a ``jax.profiler`` trace of a few full decodes and prints the device
ops that take the most time.

Usage:
  python scripts/micro_bench.py --model wlan-1296 --config wlan_T16_0.8 \
      --batch 4096 --modes take,packed [--trace-dir DIR]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, reps=10):
    """Median seconds of ``fn(*args)`` after one untimed (compiling) call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="wlan-1296")
    ap.add_argument("--config", default="wlan_T16_0.8",
                    help="decoder config under results/configs")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--modes", default="take,packed")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from informationbottleneckdecodingldpc_tpu.construct import DecoderConfig
    from informationbottleneckdecodingldpc_tpu.decode import (
        DeviceTrellis,
        ib_lut_decode,
    )
    from informationbottleneckdecodingldpc_tpu.decode.common import (
        apply_per_cn_group,
        apply_per_vn_group,
        gather_node_values_per_group,
        unsatisfied_checks,
    )
    from informationbottleneckdecodingldpc_tpu.models import get_model
    from informationbottleneckdecodingldpc_tpu.ops import lut_fold
    from informationbottleneckdecodingldpc_tpu.utils.compile_cache import (
        REPO_ROOT,
        enable_compile_cache,
    )
    from informationbottleneckdecodingldpc_tpu.utils.profiling import (
        device_op_times,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    spec = get_model(args.model)
    layout = spec.make_layout()
    cfg = DecoderConfig.load(
        os.path.join(REPO_ROOT, "results", "configs", f"{args.config}.npz")
    )
    trellis = DeviceTrellis.from_tables(cfg.tables)
    batch = args.batch
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "model": args.model, "batch": batch, "n_edges": layout.n_edges,
    }
    key = jax.random.PRNGKey(0)
    edge = jax.random.randint(key, (layout.n_edges, batch), 0, 16, jnp.int32)
    ch = jax.random.randint(key, (layout.n_vars, batch), 0, 16, jnp.int32)

    routing = {}
    for name in ("to_vn", "to_cn"):
        plan = getattr(layout, name)
        t0 = time.perf_counter()
        f_plan = jax.jit(plan.apply).lower(edge).compile()
        compile_plan = time.perf_counter() - t0
        f_take = jax.jit(lambda x, p=plan.perm: jnp.take(x, p, axis=0))
        same = bool(jnp.array_equal(f_plan(edge), f_take(edge)))
        routing[name] = {
            "pieces": plan.num_runs + plan.num_transposes,
            "use_runs": plan.use_runs,
            "plan_s": timeit(f_plan, edge),
            "take_s": timeit(f_take, edge),
            "plan_compile_s": compile_plan,
            "equal": same,
        }
    out["routing"] = routing
    print(json.dumps({"routing": routing}), flush=True)

    vmax = trellis.t_decoder
    out["modes"] = {}
    for mode in args.modes.split(","):
        lut_fold.set_lookup_mode(mode)
        cn_rest_i = trellis.cn_rest[0]

        @jax.jit
        def cn_pass(x):
            def cn_update(msgs, grp):
                return lut_fold.cn_lut_leave_one_out(
                    msgs, [cn_rest_i[l] for l in range(grp.degree - 2)],
                    vmax=vmax,
                )
            return apply_per_cn_group(layout, x, cn_update)

        vn_first_i, vn_rest_i = trellis.vn_first[0], trellis.vn_rest[0]

        @jax.jit
        def vn_pass(x, c):
            ch_groups = gather_node_values_per_group(layout, c)

            def vn_update(chv, msgs, grp):
                return lut_fold.vn_lut_leave_one_out(
                    chv, msgs, vn_first_i,
                    [vn_rest_i[l] for l in range(max(grp.degree - 2, 0))],
                    vmax=vmax,
                )
            return apply_per_vn_group(layout, x, ch_groups, vn_update)

        syn = jax.jit(lambda x: unsatisfied_checks(layout, x < vmax // 2))
        dec = jax.jit(
            lambda c: ib_lut_decode(layout, trellis, c, early_exit=False).outputs
        )
        t0 = time.perf_counter()
        jax.block_until_ready(dec(ch))
        dec_compile = time.perf_counter() - t0
        t_dec = timeit(dec, ch, reps=3)
        r = {
            "cn_pass_s": timeit(cn_pass, edge),
            "vn_pass_s": timeit(vn_pass, edge, ch),
            "syndrome_s": timeit(syn, edge),
            "decode_compile_s": dec_compile,
            "decode_s": t_dec,
            "decode_iterations": trellis.i_max - 1,
            "decode_coded_mbps": layout.n_vars * batch / t_dec / 1e6,
        }
        out["modes"][mode] = r
        print(json.dumps({mode: r}), flush=True)
        if args.trace_dir and mode == "take":
            with jax.profiler.trace(args.trace_dir):
                for _ in range(3):
                    jax.block_until_ready(dec(ch))
            out["trace_top_ops"] = device_op_times(args.trace_dir)
            print(json.dumps({"trace_top_ops": out["trace_top_ops"]}), flush=True)
    lut_fold.set_lookup_mode(None)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
