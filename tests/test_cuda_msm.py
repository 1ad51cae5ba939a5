"""The GPU bucket Pippenger (native/msm_gpu.cuh).

The CUDA build has no interpret mode, so its algorithm is checked here
through the host build of the same bodies and driver
(native/msm_gpu_host.cpp) against the native host Pippenger.  The `gpu`
test runs the CUDA build itself; it skips without a GPU."""

import random

import numpy as np
import pytest

from mira_tpu.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu.curves.jax_curve import jacobian_ops
from mira_tpu.ops import cuda_msm
from mira_tpu.ops.msm import encode_scalars
from mira_tpu.ops.native_msm import available as native_available
from mira_tpu.ops.native_msm import msm_native

CURVES = [BN254_G1, GRUMPKIN]


def _case(curve, kind, rng):
    """(scalars, points, window) for one input family."""
    r = curve.scalar_modulus
    if kind == "random":
        n, c = 96, 4
        pts = [AffinePoint.random(curve, rng) for _ in range(n)]
        sc = [rng.randrange(r) for _ in range(n)]
    elif kind == "adversarial":
        # duplicate (scalar, point) pairs, one point under two scalars,
        # opposite points, zero scalars, identity lanes, extreme scalars
        n, c = 300, 5
        base = [AffinePoint.random(curve, rng) for _ in range(40)]
        pts = [base[i % 40] for i in range(n)]
        sc = [rng.randrange(r) for _ in range(n)]
        sc[41] = sc[1]
        pts[7] = AffinePoint.identity(curve)
        pts[8] = pts[9].neg()
        sc[5] = sc[6] = 0
        sc[10] = r - 1
        sc[11] = 1
    elif kind == "skewed":
        # most scalars 0/1: one bucket holds most points, so the bucket
        # sums take several reduction passes
        n, c = 2100, 4
        base = [AffinePoint.random(curve, rng) for _ in range(64)]
        pts = [base[i % 64] for i in range(n)]
        sc = [1 if i % 5 else rng.randrange(4) for i in range(n)]
    else:  # "wide": c = 16 windows, groups of buckets with lo multiples
        n, c = 64, 16
        pts = [AffinePoint.random(curve, rng) for _ in range(n)]
        sc = [rng.randrange(r) for _ in range(n)]
        sc[0], sc[1] = 1, 2
    return sc, pts, c


@pytest.mark.parametrize("kind", ["random", "adversarial", "skewed", "wide"])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_host_build_matches_native(curve, kind):
    if not native_available():
        pytest.skip("no native toolchain")
    rng = random.Random(f"{curve.name}-{kind}")
    sc, pts, c = _case(curve, kind, rng)
    ops = jacobian_ops(curve.name)
    out = cuda_msm.msm_emulated(
        encode_scalars(sc, curve.scalar_modulus), ops.encode_points(pts),
        curve, window=c)
    got = ops.decode_points(tuple(np.asarray(o)[None] for o in out))[0]
    assert got == msm_native(sc, pts)


@pytest.mark.parametrize("window", [4, 7, 12, 16])
def test_signed_digit_recoding(window):
    """Each scalar is sum_w d_w 2^(w c) with |d_w| <= 2^(c-1); zero digits
    and identity points get the sentinel key."""
    rng = random.Random(window)
    r = BN254_G1.scalar_modulus
    vals = [rng.randrange(r) for _ in range(40)] + [0, 1, r - 1, (1 << 253) - 1]
    ident = np.zeros(len(vals), bool)
    ident[3] = True
    keys, signs = cuda_msm.digits_emulated(
        encode_scalars(vals, r), window, identity=ident)
    W, B = keys.shape[0], 1 << (window - 1)
    assert W * window >= 255
    sentinel = W * B
    for i, v in enumerate(vals):
        total = 0
        for w in range(W):
            k, s = int(keys[w, i]), int(signs[w, i])
            assert s & 0x7FFFFFFF == i
            if k == sentinel:
                continue
            assert not ident[i] and k // B == w
            mag = k % B + 1
            assert 1 <= mag <= B
            total += (-mag if s >> 31 else mag) << (w * window)
        assert total == (0 if ident[i] else v)


def test_window_grows_with_width():
    ws = [cuda_msm.window_bits(1 << k) for k in range(1, 26)]
    assert ws == sorted(ws) and min(ws) == 4 and max(ws) == 16
    assert cuda_msm.window_bits(1 << 17) == 12
    assert cuda_msm.window_bits(1 << 21) == 16


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_cuda_build_matches_native(curve, gpu):
    rng = random.Random(5)
    sc, pts, _ = _case(curve, "adversarial", rng)
    ops = jacobian_ops(curve.name)
    out = cuda_msm.msm_cuda(
        encode_scalars(sc, curve.scalar_modulus), ops.encode_points(pts),
        curve)
    got = ops.decode_points(tuple(c[None] for c in out))[0]
    assert got == msm_native(sc, pts)
