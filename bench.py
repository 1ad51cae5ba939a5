"""Benchmark harness: prints one JSON line per metric, each with the device
it ran on ({"platform", "kind", "count"} as JAX reports them).

MIRA_BENCH_METRIC picks the metric:
  ivc            k=17 Poseidon-chain IVC fold step, real 2^21 keys (default)
  ivc-snarkstar  SnarkStar (Groth16-verifier folding), batch
                 MIRA_BENCH_SNARKSTAR_BATCH (1/2/4/8/16/32)
  ivc-tensorstar TensorStar at k=22
  fold           multi-point fold evaluation, rows/s
  poseidon       batched 2-to-1 Poseidon hashes, hashes/s
  ntt            NTT, elements/s
  msm            commitment MSM on the platform's route, points/s
  scaling        sharded MSM / NTT / fold at mesh sizes 1/2/4/8, one fresh
                 process per size; on a single-device host the mesh is
                 virtual CPU devices
MIRA_BENCH_LOG_N sets the size of the kernel metrics (default 16).

Device metrics need a GPU: on any other platform the bench exits with an
error instead of measuring something else.  MIRA_BENCH_PROFILE=<path>
writes the span tree of an IVC run.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": jax.device_count()}


def _emit(rec):
    rec["device"] = _device()
    print(json.dumps(rec), flush=True)


def _dump_profile():
    """MIRA_BENCH_PROFILE=<path>: write the collected span tree + per-span
    aggregate after an IVC bench — the analog of the reference's
    build_profiling.py/analyze_profiling.py over its JSON span logs
    (/root/reference/.scripts/build_profiling.py:17-85)."""
    path = os.environ.get("MIRA_BENCH_PROFILE")
    if not path:
        return
    from mira_tpu.utils.tracing import aggregate, report

    txt = ("== span tree (>=0.05s) ==\n" + report(0.05)
           + "\n\n== per-span aggregate (>=0.01s) ==\n" + aggregate(0.01)
           + "\n")
    with open(path, "w") as f:
        f.write(txt)
    print(f"profile written to {path}", file=sys.stderr)


def _steady(step_secs, skip):
    """Median of the steps after the first `skip` (compile + capture)."""
    tail = sorted(step_secs[skip:]) if len(step_secs) > skip else sorted(step_secs)
    return tail[len(tail) // 2]


def _time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    which = os.environ.get("MIRA_BENCH_METRIC", "ivc")
    if which == "scaling":
        _scaling_driver()  # the parent process stays off JAX
        return
    if which == "scaling-worker":
        _scaling_worker()
        return

    import jax

    from mira_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {jax.default_backend()!r}")
    log_n = int(os.environ.get("MIRA_BENCH_LOG_N", "16"))
    n = 1 << log_n

    if which == "ivc":
        # IVC fold-step latency with REAL (binding) keys — the analog of the
        # reference's criterion fold_1_step/fold_2_step benches
        # (/root/reference/benches/poseidon/main.rs:161-199)
        from mira_tpu.curves.host import BN254_G1, GRUMPKIN
        from mira_tpu.ivc.ivc import IVC
        from mira_tpu.ivc.public_params import CircuitSide, PublicParams
        from mira_tpu.ivc.step_circuit import TrivialCircuit
        from mira_tpu.ops.commitment import CommitmentKey
        from mira_tpu.workloads.poseidon import PoseidonStepCircuit

        k = int(os.environ.get("MIRA_BENCH_IVC_K", "17"))
        steps = int(os.environ.get("MIRA_BENCH_IVC_STEPS", "5"))
        t0 = time.perf_counter()
        ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, k + 4, "bn256")
        ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, k + 4, "grumpkin")
        sc1 = PoseidonStepCircuit(BN254_G1.scalar_modulus, 1)
        sc2 = TrivialCircuit(arity=1)
        pp = PublicParams(
            CircuitSide(sc1, ck1, k), CircuitSide(sc2, ck2, k),
            BN254_G1, GRUMPKIN,
        )
        ivc = IVC(pp, sc1, [0], sc2, [0])
        setup = time.perf_counter() - t0
        step_secs = []
        for _ in range(steps):
            t0 = time.perf_counter()
            ivc.fold_step()
            step_secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ivc.verify(strict=True)
        decider = time.perf_counter() - t0
        _emit({
            "metric": f"ivc_fold_step_sec@k{k}",
            "value": _steady(step_secs, 2),
            "unit": "s/step",
            "all_steps": step_secs,
            "setup_s": setup,
            "decider_s": decider,
        })
        _dump_profile()
        return

    if which == "ivc-snarkstar":
        # SnarkStar (Groth16-verifier folding) at the reference's ladder
        # (/root/reference/examples/groth16/main.rs:47-77): real keys, real
        # Groth16 proofs, true Gt cross terms, strict verify inside run()
        steps = int(os.environ.get("MIRA_BENCH_IVC_STEPS", "4"))
        batch = int(os.environ.get("MIRA_BENCH_SNARKSTAR_BATCH", "1"))
        if batch not in (1, 2, 4, 8, 16, 32):
            raise SystemExit(
                f"MIRA_BENCH_SNARKSTAR_BATCH={batch} is not a reference "
                "ladder rung; pick one of 1/2/4/8/16/32")
        from mira_tpu.workloads.snarkstar import ck_sizes, table_sizes
        from mira_tpu.workloads.snarkstar import run as snarkstar_run

        step_secs = snarkstar_run(
            steps=steps, batch_size=batch, use_mock_ck=False, real_proofs=True
        )
        _emit({
            "metric": f"snarkstar_fold_step_sec@b{batch}-k{table_sizes(batch)[0]}"
                      f"-ck{ck_sizes(batch)[0]}",
            "value": _steady(step_secs, 2),
            "unit": "s/step",
            "all_steps": step_secs,
        })
        _dump_profile()
        return

    if which == "ivc-tensorstar":
        # TensorStar (zkml program-counter folding) with the zkml pairing
        # instance shape (/root/reference/examples/zkml/main.rs:183-190) and
        # real keys at the reference's k=22
        steps = int(os.environ.get("MIRA_BENCH_IVC_STEPS", "3"))
        from mira_tpu.workloads.tensorstar import run as tensorstar_run

        step_secs = tensorstar_run(
            repeat_count=steps, matrix_dim=128, use_mock_ck=False)
        _emit({
            "metric": "tensorstar_fold_step_sec@k22",
            "value": _steady(step_secs, 1),
            "unit": "s/step",
            "all_steps": step_secs,
        })
        _dump_profile()
        return

    import random

    from mira_tpu.fields.limbs import limb_field
    from mira_tpu.fields.params import BN254_FR

    rng = random.Random(0)
    lf = limb_field(BN254_FR)

    if which == "fold":
        # per-fold hot path: the multi-point fold evaluation (the reference's
        # criterion fold_step benches measure the same inner work,
        # benches/poseidon/main.rs:161-199)
        from mira_tpu.workloads.demo import demo_structure

        k = min(log_n, 20)
        S, advice = demo_structure(k)
        nrow = 1 << k
        w_vals = []
        for col in advice:
            w_vals.extend(col + [0] * (nrow - len(col)))
        W0 = lf.encode(w_vals)
        W2 = lf.mul(W0, lf.encode([3])[0][None])
        js = [1, 2, 3, 4, 5]
        from mira_tpu.routes import route

        ev = (S._native_fold_evaluator() if route("fold_eval") == "native"
              else S._fold_evaluator())
        dt = _time(lambda: ev.fold_eval_multi((W0,), (W2,), js, [12345, 1],
                                              [777, 1]), 5)
        _emit({"metric": f"fold_rows_per_sec@2^{k}",
               "value": len(js) * nrow / dt, "unit": "rows/s"})
        return

    if which == "poseidon":
        from mira_tpu.ops.poseidon_device import poseidon_hash_batch

        vals = lf.encode(
            [rng.randrange(BN254_FR) for _ in range(2 * n)]
        ).reshape(n, 2, 16)
        dt = _time(lambda: poseidon_hash_batch(vals, BN254_FR), 5)
        _emit({"metric": f"poseidon_hashes_per_sec@2^{log_n}",
               "value": n / dt, "unit": "hashes/s"})
        return

    if which == "ntt":
        from mira_tpu.ops.ntt import ntt

        a = lf.encode([rng.randrange(BN254_FR) for _ in range(n)])
        dt = _time(lambda: ntt(a, BN254_FR), 5)
        _emit({"metric": f"ntt_elems_per_sec@2^{log_n}",
               "value": n / dt, "unit": "elems/s"})
        return

    if which == "msm":
        import numpy as np

        from mira_tpu.curves.host import BN254_G1
        from mira_tpu.ops.commitment import CommitmentKey
        from mira_tpu.ops.msm import msm_device
        from mira_tpu.routes import route

        ck = CommitmentKey.setup(BN254_G1, log_n, b"bench-msm")
        pts = ck._enc_slice(n)
        sc = np.random.default_rng(0).integers(
            0, 1 << 16, size=(n, 16), dtype=np.uint32)
        sc[:, 15] &= 0x1FFF  # < 2^253 < r
        import jax.numpy as jnp

        scd = jnp.asarray(sc)
        dt = _time(lambda: msm_device(scd, pts, BN254_G1), 3)
        _emit({"metric": f"msm_points_per_sec@2^{log_n}", "value": n / dt,
               "unit": "points/s", "route": route("msm")})
        return

    raise SystemExit(f"unknown MIRA_BENCH_METRIC={which!r}")


def _scaling_driver():
    """Scaling harness: each sharded kernel at mesh sizes 1/2/4/8 in fresh
    processes (XLA's device count is fixed at backend init), reporting
    eff@n = throughput(n) / (n * throughput(1)) per kernel, one JSON line
    each.  This parent never initializes JAX, so a worker never shares a
    card with a live parent; workers run one at a time.  With fewer than
    two GPUs the mesh is virtual CPU devices, which share the host's cores,
    so its efficiencies say nothing about a device."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.default_backend(), jax.device_count())"],
        capture_output=True, text=True, timeout=600,
    )
    backend, ndev = probe.stdout.split()
    virtual = backend != "gpu" or int(ndev) < 2
    sizes = (1, 2, 4, 8) if virtual else tuple(
        s for s in (1, 2, 4, 8) if s <= int(ndev))
    for kern in ("msm", "ntt", "fold"):
        thr = {}
        for n in sizes:
            env = dict(os.environ)
            env["MIRA_BENCH_METRIC"] = "scaling-worker"
            env["MIRA_SCALING_N"] = str(n)
            env["MIRA_SCALING_KERNEL"] = kern
            if virtual:
                env["JAX_PLATFORMS"] = "cpu"
                env["XLA_FLAGS"] = (
                    env.get("XLA_FLAGS", "")
                    + f" --xla_force_host_platform_device_count={n}"
                ).strip()
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=env, capture_output=True, text=True, timeout=3600,
            )
            line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
            if not line:
                raise SystemExit(f"scaling worker failed (kern={kern} n={n}): "
                                 f"{r.stderr[-2000:]}")
            rec = json.loads(line[-1])
            thr[n] = rec["throughput"]
            device = rec["device"]
        effs = {n: thr[n] / (n * thr[1]) for n in thr}
        top = max(thr)
        print(json.dumps({
            "metric": f"scaling_efficiency@{kern}",
            "value": effs[top],
            "unit": f"eff@{top}dev",
            "throughput_per_mesh": {str(n): v for n, v in thr.items()},
            "eff_per_mesh": {str(n): v for n, v in effs.items()},
            "device": device,
        }), flush=True)


def _scaling_worker():
    """One (kernel, mesh size) throughput measurement; prints
    {"throughput": ops_per_sec, "device": ...}."""
    import random

    import jax

    from mira_tpu.fields.limbs import limb_field
    from mira_tpu.fields.params import BN254_FR
    from mira_tpu.parallel.mesh import AXIS, make_mesh

    n_mesh = int(os.environ["MIRA_SCALING_N"])
    kern = os.environ["MIRA_SCALING_KERNEL"]
    mesh = make_mesh(n_mesh)
    lf = limb_field(BN254_FR)
    rng = random.Random(0)

    if kern == "msm":
        from mira_tpu.curves.host import BN254_G1
        from mira_tpu.ops.commitment import CommitmentKey
        from mira_tpu.ops.msm import encode_scalars

        log_n = int(os.environ.get("MIRA_SCALING_MSM_LOG_N", "19"))
        n = 1 << log_n
        ck = CommitmentKey.load_or_setup_cache(BN254_G1, log_n, "scaling")
        enc_pts = ck._enc
        sc = encode_scalars(
            [rng.randrange(BN254_G1.scalar_modulus) for _ in range(n)],
            BN254_G1.scalar_modulus,
        )
        if jax.default_backend() == "cpu":
            # host-threaded shard engine (parallel/msm.py sharded_msm_host):
            # same shard decomposition, engine and reduction, rayon-style
            import numpy as np

            from mira_tpu.parallel.msm import sharded_msm_host

            sc_np = np.asarray(sc)
            pts_np = tuple(np.asarray(c) for c in enc_pts)

            def run():
                return sharded_msm_host(sc_np, pts_np, BN254_G1, n_mesh)
        else:
            from mira_tpu.parallel.msm import sharded_msm

            def run():
                return sharded_msm(sc, enc_pts, BN254_G1, mesh)

    elif kern == "ntt":
        from mira_tpu.parallel.ntt import distributed_ntt

        n = 1 << int(os.environ.get("MIRA_SCALING_NTT_LOG_N", "14"))
        a = lf.encode([rng.randrange(BN254_FR) for _ in range(n)])

        def run():
            return distributed_ntt(a, BN254_FR, mesh)

    else:  # fold: row-sharded witness RLC + quadratic gate term
        from functools import partial

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        n = 1 << int(os.environ.get("MIRA_SCALING_FOLD_LOG_N", "16"))
        W = lf.encode([rng.randrange(BN254_FR) for _ in range(n)])
        r = lf.encode([7])

        @jax.jit
        @partial(
            shard_map, mesh=mesh, in_specs=(P(AXIS), P(None)),
            out_specs=P(AXIS), check_vma=False,
        )
        def fold_rows(w, r_):
            folded = lf.add(w, lf.mul(r_, w))
            return lf.mul(folded, folded)

        def run():
            return fold_rows(W, r)

    dt = _time(run, 3)
    print(json.dumps({"throughput": n / dt, "device": _device()}))


if __name__ == "__main__":
    main()
