#!/usr/bin/env python3
"""Smoke test of mira_tpu on one NVIDIA GPU: `python chip_smoke.py`.

Phases, in order; any failure exits non-zero at once:
  1. device and routes: the card (nvidia-smi), jax.devices(), the route
     table (mira_tpu/routes.py), which native libraries built; the CUDA MSM
     library is built here (nvcc, sm_90a).  Refuses any platform but "gpu".
  2. kernel checks at real widths against the repo's plain references:
     the MSM route on BN254 and Grumpkin at 2^17 and 2^21 (duplicate
     (scalar, point) pairs, opposite points, zero scalars and identity lanes
     included) and at the delta-commit shape (250,000 gathered key points)
     against the native C++ Pippenger; the device fold evaluator on the
     k=17 step-folding structure against the native C++ row VM on every
     row; the NTT at 2^16 against the host NTT; the device Poseidon against
     the host sponge.
     Every comparison is exact equality: the arithmetic is integer limb
     arithmetic, so no tolerance applies and TF32 cannot arise.
  3. main path, through the entry points a user calls:
     CommitmentKey.load_or_setup_cache (2^21 keys on both curves),
     PublicParams, IVC(...), 3 x fold_step(), verify(strict=True).  One
     step's cross-term commitments are recomputed with the native host MSM.
  4. the last line of stdout: {"ok": true, "device": {...}}.

`--four` runs only the four-card phase: one k=17 fold step on a 4-device
mesh against the same step on one card, the sharded MSM at 2^21 and the
distributed NTT against their single-card results.

Weights are keys and witnesses made from fixed seeds.  Timing lines name the
card and its power limit.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 17  # the step-folding circuit's rows
KEY_LOG = 21  # commitment keys, both curves
SEED = 1017


def log(msg=""):
    print(msg, flush=True)


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out[0] if out else "nvidia-smi printed nothing"


class Smoke:
    def __init__(self):
        import jax

        self.jax = jax
        self.card = card()
        self.rng = random.Random(SEED)
        self.keys = {}
        self.pp = None

    def timed(self, what, seconds):
        log(f"[{self.card}] {what}: {seconds:.3f} s")

    def spans(self, what):
        """The host spans (utils/tracing.py) of the last traced call, busy
        time per span name; spans under 10 ms are left out."""
        from mira_tpu.utils import tracing

        log(f"[{self.card}] spans of {what} (host clock):")
        for line in tracing.aggregate(min_runtime=0.01).splitlines():
            log(f"  {line}")

    # -- shared set-up -----------------------------------------------------
    def load_keys(self):
        from mira_tpu.curves.host import BN254_G1, GRUMPKIN
        from mira_tpu.ops.commitment import CommitmentKey

        t0 = time.perf_counter()
        self.keys["bn254"] = CommitmentKey.load_or_setup_cache(
            BN254_G1, KEY_LOG, "bn256")
        self.keys["grumpkin"] = CommitmentKey.load_or_setup_cache(
            GRUMPKIN, KEY_LOG, "grumpkin")
        self.keys_s = time.perf_counter() - t0
        self.timed(f"key setup (2 x 2^{KEY_LOG})", self.keys_s)

    def public_params(self):
        from mira_tpu.curves.host import BN254_G1, GRUMPKIN
        from mira_tpu.ivc.public_params import CircuitSide, PublicParams
        from mira_tpu.ivc.step_circuit import TrivialCircuit
        from mira_tpu.workloads.poseidon import PoseidonStepCircuit

        t0 = time.perf_counter()
        self.sc1 = PoseidonStepCircuit(BN254_G1.scalar_modulus, 1)
        self.sc2 = TrivialCircuit(arity=1)
        self.pp = PublicParams(
            CircuitSide(self.sc1, self.keys["bn254"], K),
            CircuitSide(self.sc2, self.keys["grumpkin"], K),
            BN254_G1, GRUMPKIN,
        )
        self.pp_s = time.perf_counter() - t0
        self.timed(f"PublicParams (k={K})", self.pp_s)

    def new_ivc(self):
        from mira_tpu.ivc.ivc import IVC

        return IVC(self.pp, self.sc1, [0], self.sc2, [0])

    # -- phase 1 -------------------------------------------------------------
    def phase_device(self):
        jax = self.jax
        from mira_tpu import routes
        from mira_tpu.ops import cuda_msm, native_keygen, native_msm
        from mira_tpu.polynomial import native_evaluator
        from mira_tpu.utils import native_lib
        from mira_tpu.utils.compile_cache import enable_persistent_cache

        log(self.card)
        log(f"jax {jax.__version__} devices: {jax.devices()}")
        log(f"compile cache: {enable_persistent_cache()}")
        if jax.default_backend() != "gpu":
            raise RuntimeError(
                f"needs a GPU; JAX's default backend is {jax.default_backend()!r}")
        log(f"routes on {routes.platform()}: {json.dumps(routes.table())}")
        built = {
            "msm.cpp": native_msm.available(),
            "evaluator.cpp": native_evaluator.available(),
            "tape_vm.cpp": native_lib.tape_vm_available(),
            "pairing.cpp": native_lib.pairing_available(),
            "keygen.cpp": native_keygen.available(),
        }
        t0 = time.perf_counter()
        so = cuda_msm.build_library()
        cuda_msm._library()
        built["msm_gpu.cu"] = os.path.basename(so)
        log(f"native libraries: {json.dumps(built)}")
        self.timed("CUDA MSM library build + load", time.perf_counter() - t0)
        missing = [k for k, v in built.items() if not v]
        if missing:
            raise RuntimeError(f"native libraries failed to build: {missing}")

    # -- phase 2 -------------------------------------------------------------
    def _msm_case(self, curve, n, positions=None, reps=3):
        """Device MSM route vs the native C++ Pippenger over the first n key
        points (or the key points at `positions`, padded to a power of two
        as commit_delta pads them)."""
        import jax.numpy as jnp
        import numpy as np

        from mira_tpu.curves.host import AffinePoint
        from mira_tpu.curves.jax_curve import jacobian_ops
        from mira_tpu.fields.host import field
        from mira_tpu.fields.limbs import limb_field
        from mira_tpu.fields.native64 import limbs16_to_64, u64_to_int
        from mira_tpu.ops.msm import msm_device
        from mira_tpu.ops.native_msm import msm_native_raw

        jax = self.jax
        ck = self.keys[curve.name]
        nr = np.random.default_rng(self.rng.randrange(1 << 30))
        if positions is None:
            raw = ck._limbs[:n].copy()
            m = n
        else:
            m = len(positions)
            idx = np.concatenate([positions, np.zeros(n - m, positions.dtype)])
            raw = ck._limbs[idx].copy()
        # scalars: uniform below 2^253 (< both scalar fields), a third of
        # them small (0, 1, 2) as witness cells often are
        sc = nr.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
        sc[:, 15] &= 0x1FFF
        small = nr.random(n) < 0.33
        sc[small] = 0
        sc[small, 0] = nr.integers(0, 3, size=int(small.sum()))
        sc[m:] = 0  # padding lanes
        ident = np.zeros(n, bool)
        if positions is None:
            # adversarial lanes: exact duplicate (scalar, point) pairs, the
            # same point under another scalar, opposite points, zero
            # scalars, identity points
            k = max(n // 1024, 4)
            lanes = nr.choice(n, size=5 * k, replace=False)
            dup, same, opp, zero, idl = np.split(lanes, 5)
            src = nr.choice(n, size=k, replace=False)
            raw[dup] = raw[src]
            sc[dup] = sc[src]
            raw[same] = raw[src]
            p = curve.base_modulus
            for i, j in zip(opp, src):
                y = sum(int(v) << (16 * t) for t, v in enumerate(raw[j, 1]))
                ny = (p - y) % p
                raw[i, 0] = raw[j, 0]
                raw[i, 1] = [(ny >> (16 * t)) & 0xFFFF for t in range(16)]
            sc[zero] = 0
            ident[idl] = True
        lfq = limb_field(curve.base_modulus)
        X = lfq.encode_raw16(raw[:, 0])
        Y = lfq.encode_raw16(raw[:, 1])
        one = jnp.asarray(lfq.one_mont_np, dtype=jnp.uint32)
        Z = jnp.where(jnp.asarray(ident)[:, None], jnp.uint32(0), one[None])
        scd = jnp.asarray(sc)
        out = jax.block_until_ready(msm_device(scd, (X, Y, Z), curve))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(msm_device(scd, (X, Y, Z), curve))
            ts.append(time.perf_counter() - t0)
        got = jacobian_ops(curve.name).decode_points(
            tuple(c[None] for c in out))[0]
        xs = limbs16_to_64(raw[:, 0])
        ys = limbs16_to_64(raw[:, 1])
        xs[ident] = 0
        ys[ident] = 0
        t0 = time.perf_counter()
        jac = msm_native_raw(limbs16_to_64(sc), xs, ys, curve.base_modulus)
        t_native = time.perf_counter() - t0
        p = curve.base_modulus
        F = field(p)
        xj, yj, zj = (u64_to_int(jac[i]) for i in range(3))
        if zj == 0:
            want = AffinePoint.identity(curve)
        else:
            zi = pow(zj, -1, p)
            want = AffinePoint(curve, F(xj * zi * zi), F(yj * zi * zi * zi))
        shape = f"2^{n.bit_length() - 1}" if positions is None else \
            f"{m} gathered points (padded to {n})"
        if got != want:
            raise AssertionError(f"MSM {curve.name} {shape}: device != native")
        log(f"[{self.card}] msm {curve.name} {shape}: equal; device "
            f"{min(ts) * 1e3:.2f} ms (best of {reps}), native host "
            f"{t_native * 1e3:.1f} ms")

    def _fold_eval_check(self):
        """The GPU fold_eval route (the device loop of
        polynomial/fold_evaluator.py) on the k=17 step-folding structure,
        fed from device arrays, against the native C++ row VM on every row
        of every interior fold point."""
        import numpy as np

        from mira_tpu.fields.limbs import limb_field
        from mira_tpu.routes import route

        if route("fold_eval") != "jnp":
            raise AssertionError(
                f"fold_eval routes to {route('fold_eval')!r} on the GPU")
        S = self.pp.primary.S
        lf = limb_field(S.modulus)
        p = S.modulus
        nrow = 1 << S.k
        nr = np.random.default_rng(SEED)

        def rounds():
            out = []
            for size in S.round_sizes:
                raw = nr.integers(0, 1 << 16, size=(size, 16), dtype=np.uint32)
                raw[:, 15] &= 0x1FFF
                out.append(lf.encode_raw16(raw))
            return tuple(out)

        W1, W2 = rounds(), rounds()
        n_ch = S.num_challenges + 1
        ch1 = [self.rng.randrange(p) for _ in range(n_ch)]
        ch2 = [self.rng.randrange(p) for _ in range(n_ch)]
        d = S.get_degree_for_folding() - 1
        js = list(range(1, d)) or [1]
        ev = S._fold_evaluator()
        t0 = time.perf_counter()
        got = self.jax.block_until_ready(ev.fold_eval_multi(W1, W2, js, ch1, ch2))
        t_first = time.perf_counter() - t0
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = self.jax.block_until_ready(
                ev.fold_eval_multi(W1, W2, js, ch1, ch2))
            ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = S._native_fold_evaluator().fold_eval_multi(W1, W2, js, ch1, ch2)
        t_native = time.perf_counter() - t0
        if not np.array_equal(np.asarray(got), want):
            raise AssertionError("fold eval: device loop != native row VM")
        log(f"[{self.card}] fold eval k={S.k}, {len(js)} points x {nrow} "
            f"rows, {sum(S.round_sizes) >> S.k} witness columns: equal to the "
            f"native row VM on every row; device {min(ts):.4f} s (best of 3, "
            f"first call {t_first:.3f} s), native row VM {t_native:.3f} s")

    def _ntt_check(self):
        from mira_tpu.fields.limbs import limb_field
        from mira_tpu.fields.params import BN254_FR
        from mira_tpu.ops.ntt import ntt, ntt_host

        lf = limb_field(BN254_FR)
        vals = [self.rng.randrange(BN254_FR) for _ in range(1 << 16)]
        if lf.decode(ntt(lf.encode(vals), BN254_FR)) != ntt_host(vals, BN254_FR):
            raise AssertionError("NTT 2^16 != host NTT")
        log("ntt 2^16: equal to the host NTT")

    def _poseidon_check(self):
        from mira_tpu.fields.host import field
        from mira_tpu.fields.limbs import limb_field
        from mira_tpu.fields.params import BN254_FR
        from mira_tpu.ops.poseidon import PoseidonHash, get_spec
        from mira_tpu.ops.poseidon_device import poseidon_hash_batch

        F = field(BN254_FR)
        lf = limb_field(BN254_FR)
        n, t, rate, length = 256, 3, 2, 2
        rows = [[self.rng.randrange(BN254_FR) for _ in range(length)]
                for _ in range(n)]
        enc = lf.encode([v for r in rows for v in r]).reshape(n, length, -1)
        got = lf.decode(poseidon_hash_batch(enc, BN254_FR, t=t, rate=rate))
        for i, row in enumerate(rows):
            # the host sponge's state[1] before bit truncation
            h = PoseidonHash(get_spec(BN254_FR, t, rate, 10, 10))
            h.update([F(v) for v in row])
            buf, h.buf = h.buf, []
            for j in range(0, len(buf), rate):
                h.permutation(buf[j:j + rate])
            if len(buf) % rate == 0:
                h.permutation([])
            if got[i] != h.state[1].v:
                raise AssertionError(f"device Poseidon != host sponge, row {i}")
        log(f"poseidon batch of {n} (t={t}): equal to the host sponge")

    def phase_kernels(self):
        import numpy as np

        from mira_tpu.curves.host import BN254_G1, GRUMPKIN

        self.load_keys()
        for curve in (BN254_G1, GRUMPKIN):
            for log_n in (17, KEY_LOG):
                self._msm_case(curve, 1 << log_n)
        nr = np.random.default_rng(SEED + 1)
        positions = np.sort(nr.choice(1 << KEY_LOG, size=250_000,
                                      replace=False))
        for curve in (BN254_G1, GRUMPKIN):
            self._msm_case(curve, 1 << 18, positions=positions)
        self.public_params()
        self._fold_eval_check()
        self._ntt_check()
        self._poseidon_check()

    # -- phase 3 -------------------------------------------------------------
    def phase_main(self):
        import numpy as np

        from mira_tpu.curves.host import AffinePoint
        from mira_tpu.fields.host import field
        from mira_tpu.fields.native64 import (
            from_mont16,
            limbs16_to_64,
            u64_to_int,
        )
        from mira_tpu.ops.native_msm import msm_native_raw
        from mira_tpu.utils import tracing

        jax = self.jax
        t0 = time.perf_counter()
        ivc = self.new_ivc()
        zero_s = time.perf_counter() - t0
        self.timed("IVC zero step", zero_s)
        self.timed("setup (keys + PublicParams + zero step)",
                   self.keys_s + self.pp_s + zero_s)

        ck = self.pp.primary.ck
        rec = {}
        orig = ck.commit_device_many

        def recording(vectors, mesh=None, defer=False):
            out = orig(vectors, mesh=mesh, defer=defer)
            if "vectors" in rec:
                return out
            rec["vectors"] = list(vectors)

            def keep(pts):
                rec["points"] = list(pts)
                return pts

            return (lambda: keep(out())) if defer else keep(out)

        steps = []
        for i in range(3):
            if i == 1:
                ck.commit_device_many = recording
            tracing.reset()
            t0 = time.perf_counter()
            ivc.fold_step()
            steps.append(time.perf_counter() - t0)
            if i == 1:
                del ck.commit_device_many
            self.timed(f"fold step {i + 1}", steps[-1])
        self.spans("fold step 3")
        tracing.reset()
        t0 = time.perf_counter()
        ivc.verify(strict=True)
        self.timed("verify(strict=True)", time.perf_counter() - t0)
        self.spans("verify(strict=True)")

        # one step's cross-term commitments, recomputed on the host
        if not rec.get("vectors"):
            raise AssertionError("no cross-term commitment was recorded")
        curve = ck.curve
        p = curve.base_modulus
        F = field(p)
        for v, pt in zip(rec["vectors"], rec["points"]):
            n = v.shape[0]
            sc = limbs16_to_64(from_mont16(curve.scalar_modulus, np.asarray(v)))
            jac = msm_native_raw(sc, limbs16_to_64(ck._limbs[:n, 0]),
                                 limbs16_to_64(ck._limbs[:n, 1]), p)
            xj, yj, zj = (u64_to_int(jac[i]) for i in range(3))
            if zj == 0:
                want = AffinePoint.identity(curve)
            else:
                zi = pow(zj, -1, p)
                want = AffinePoint(curve, F(xj * zi * zi),
                                   F(yj * zi * zi * zi))
            if want != pt:
                raise AssertionError("cross-term commitment: device != host")
        log(f"step 2 cross-term commitments ({len(rec['vectors'])}): equal "
            "to the native host MSM")
        peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
        log(f"[{self.card}] peak_bytes_in_use: {peak}")

    # -- four cards ------------------------------------------------------------
    def phase_four(self):
        import jax.numpy as jnp
        import numpy as np

        from mira_tpu.curves.host import BN254_G1
        from mira_tpu.curves.jax_curve import jacobian_ops
        from mira_tpu.fields.limbs import limb_field
        from mira_tpu.fields.params import BN254_FR
        from mira_tpu.ops.msm import msm_device
        from mira_tpu.ops.ntt import ntt
        from mira_tpu.parallel.mesh import make_mesh
        from mira_tpu.parallel.msm import sharded_msm
        from mira_tpu.parallel.ntt import distributed_ntt

        jax = self.jax
        devs = jax.devices()
        if len(devs) != 4:
            raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
        mesh = make_mesh(4)
        self.load_keys()
        self.public_params()

        # one k=17 fold step on the mesh against the same step on one card
        single, multi = self.new_ivc(), self.new_ivc()
        t0 = time.perf_counter()
        single.fold_step()
        self.timed("fold step, one card", time.perf_counter() - t0)
        t0 = time.perf_counter()
        multi.fold_step(mesh=mesh)
        self.timed("fold step, 4-device mesh", time.perf_counter() - t0)
        for side in ("primary", "secondary"):
            a = getattr(single, side).relaxed_trace
            b = getattr(multi, side).relaxed_trace
            if a.U != b.U:
                raise AssertionError(f"mesh fold: {side} instance differs")
            for wa, wb in zip(a.W.W + [a.W.E], b.W.W + [b.W.E]):
                if not np.array_equal(np.asarray(wa), np.asarray(wb)):
                    raise AssertionError(f"mesh fold: {side} witness differs")
        if single.secondary_trace.u != multi.secondary_trace.u:
            raise AssertionError("mesh fold: fresh secondary instance differs")
        log("mesh fold == single-card fold (instances, witnesses)")

        # sharded MSM at 2^21 against one card
        n = 1 << KEY_LOG
        ck = self.keys["bn254"]
        nr = np.random.default_rng(SEED)
        sc = nr.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
        sc[:, 15] &= 0x1FFF
        scd = jnp.asarray(sc)
        pts = ck._enc_slice(n)
        ops = jacobian_ops("bn254")
        t0 = time.perf_counter()
        out_m = jax.block_until_ready(sharded_msm(scd, pts, BN254_G1, mesh))
        t_m = time.perf_counter() - t0
        out_1 = jax.block_until_ready(msm_device(scd, pts, BN254_G1))
        got = ops.decode_points(tuple(c[None] for c in out_m))[0]
        want = ops.decode_points(tuple(c[None] for c in out_1))[0]
        if got != want:
            raise AssertionError("sharded MSM 2^21 != single-card MSM")
        log(f"[{self.card}] sharded MSM 2^{KEY_LOG} over 4 devices: equal to "
            f"one card (first call {t_m:.3f} s)")

        # distributed NTT
        lf = limb_field(BN254_FR)
        a = lf.encode([self.rng.randrange(BN254_FR) for _ in range(1 << 12)])
        if lf.decode(distributed_ntt(a, BN254_FR, mesh)) != lf.decode(
                ntt(a, BN254_FR)):
            raise AssertionError("distributed NTT != single-card NTT")
        log("distributed NTT 2^12: equal to one card")

        # the work reached every device, not device 0 alone
        peaks = [d.memory_stats().get("peak_bytes_in_use", 0) for d in devs]
        log(f"[{self.card}] peak_bytes_in_use per device: {peaks}")
        if min(peaks) < (64 << 20):
            raise AssertionError(f"a device did almost no work: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import jax

        import mira_tpu.routes  # noqa: F401  (the repo must be present)
    except ImportError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    try:
        platform = jax.devices()[0].platform
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    if platform != "gpu":
        print(f"FAIL: needs a GPU; JAX found {platform!r}", file=sys.stderr)
        return 2

    smoke = Smoke()
    if args.four:
        phases = [("device and routes", smoke.phase_device),
                  ("four cards", smoke.phase_four)]
    else:
        phases = [("device and routes", smoke.phase_device),
                  ("kernel checks", smoke.phase_kernels),
                  ("main path", smoke.phase_main)]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase: {name}")
        try:
            fn()
        except Exception:  # noqa: BLE001 - report and fail the run
            traceback.print_exc()
            log(f"FAIL: phase {name!r}")
            return 1
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    devs = jax.devices()
    log(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
