"""Commitment-key setup: native keygen parity + cache validation.

Covers the reference's setup/cache semantics
(/root/reference/src/commitment.rs:39-167): XOF-derived generators,
load-or-setup disk cache, on-curve revalidation on load.
"""

import hashlib
import os

import numpy as np
import pytest

from mira_tpu.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu.ops.commitment import CommitmentKey, map_to_curve
from mira_tpu.routes import forced
from mira_tpu.ops.native_keygen import (
    available,
    keygen_native,
    limbs16_to_u64x4,
    on_curve_check_native,
    u64x4_to_limbs16,
)


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN], ids=lambda c: c.name)
def test_native_keygen_matches_python_svdw(curve):
    if not available():
        pytest.skip("no native toolchain")
    n = 8
    label = b"paritytest"
    xy = keygen_native(curve, n, label)
    assert xy is not None and xy.shape == (n, 2, 4)
    stream = hashlib.shake_256(label).digest(32 * n)
    for i in range(n):
        p = map_to_curve(curve, stream[32 * i : 32 * (i + 1)])
        x = int.from_bytes(np.ascontiguousarray(xy[i, 0]).tobytes(), "little")
        y = int.from_bytes(np.ascontiguousarray(xy[i, 1]).tobytes(), "little")
        assert (p.x.v, p.y.v) == (x, y), f"point {i} diverges from python svdw"
    assert on_curve_check_native(xy, curve) == 0


def test_limb_u64_roundtrip():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 63, size=(5, 2, 4), dtype=np.uint64)
    assert np.array_equal(limbs16_to_u64x4(u64x4_to_limbs16(a)), a)


def test_setup_array_backed_and_lazy_points():
    ck = CommitmentKey.setup(BN254_G1, 3, b"t")
    assert len(ck) == 8
    assert ck._points is None  # not materialized until asked
    pts = ck.points
    assert all(isinstance(p, AffinePoint) and p.is_on_curve() for p in pts)


def test_cache_roundtrip_and_corruption_detection(tmp_path):
    d = str(tmp_path)
    ck = CommitmentKey.load_or_setup_cache(BN254_G1, 3, "cachetest", cache_dir=d)
    ck2 = CommitmentKey.load_or_setup_cache(BN254_G1, 3, "cachetest", cache_dir=d)
    assert np.array_equal(ck._limbs, ck2._limbs)
    # corrupt one limb and expect the on-curve validation to fire
    import glob
    import os

    path = glob.glob(os.path.join(d, "**", "*.npy"), recursive=True)[0]
    arr = np.load(path)
    arr[0, 0, 0] ^= 1
    np.save(path, arr)
    with pytest.raises(ValueError, match="corrupted"):
        CommitmentKey.load_or_setup_cache(BN254_G1, 3, "cachetest", cache_dir=d)


def test_commit_ints_matches_naive():
    ck = CommitmentKey.setup(BN254_G1, 2, b"commit")
    vals = [5, 7, 11, 13]
    got = ck.commit_ints(vals)
    want = None
    for v, p in zip(vals, ck.points):
        term = p.scalar_mul(v)
        want = term if want is None else want.add(term)
    assert got.x.v == want.x.v and got.y.v == want.y.v


@pytest.mark.parametrize("msm_route", ["native", "xla"])
def test_commit_delta_matches_full_commit(msm_route):
    """C(template) + MSM(delta @ positions) == C(scattered witness) — the
    incremental witness commitment of the device-resident tape-replay path
    (ops/commitment.py commit_delta; replaces the reference's full
    best_multiexp per SPS round, /root/reference/src/plonk/mod.rs:653-907).
    On the device routes the delta MSM runs over the gathered key points,
    padded to a power of two."""
    import random

    import jax.numpy as jnp

    from mira_tpu.fields.limbs import NUM_LIMBS, ints_to_limbs, limb_field
    from mira_tpu.table.packed import DeviceWitness

    rng = random.Random(7)
    curve = BN254_G1
    num_cols, nrow = 4, 64
    n = num_cols * nrow
    ck = CommitmentKey.setup(curve, 8, b"delta-test")
    lf = limb_field(curve.scalar_modulus)

    template_vals = [rng.randrange(curve.scalar_modulus) for _ in range(n)]
    template_mont = lf.encode(template_vals)
    positions_np = np.asarray(
        sorted(rng.sample(range(n), 40)), dtype=np.int64
    )
    positions = jnp.asarray(positions_np, dtype=jnp.int32)
    new_vals = [rng.randrange(curve.scalar_modulus) for _ in positions_np]
    vals16 = jnp.asarray(ints_to_limbs(new_vals))

    class _Tok:  # stands in for CapturedSynthesis as the cache key
        pass

    dw = DeviceWitness(
        lf, _Tok(), template_mont, template_mont[positions],
        positions, positions_np, vals16, num_cols, nrow,
    )

    # scatter correctness: encode_mont == template with updates applied
    got = lf.decode(dw.encode_mont(lf))
    want = list(template_vals)
    for p, v in zip(positions_np, new_vals):
        want[int(p)] = v
    assert got == want

    # delta commitment == full commitment of the scattered witness
    with forced("msm", msm_route):
        c_delta = ck.commit_delta(dw)
        entry = next(iter(ck._delta_cache.values()))
        assert (entry[1] is None) == (msm_route == "native")
    c_full = ck.commit_ints(want)
    assert c_delta == c_full

    # second step over the same tape reuses the cached template commitment
    new_vals2 = [rng.randrange(curve.scalar_modulus) for _ in positions_np]
    dw2 = DeviceWitness(
        lf, dw.cache_token, template_mont, template_mont[positions],
        positions, positions_np, jnp.asarray(ints_to_limbs(new_vals2)),
        num_cols, nrow,
    )
    want2 = list(template_vals)
    for p, v in zip(positions_np, new_vals2):
        want2[int(p)] = v
    with forced("msm", msm_route):
        assert ck.commit_delta(dw2) == ck.commit_ints(want2)


def test_delta_template_commitment_persists(tmp_path):
    """The template commitment is deterministic per (key, template bytes);
    commit_delta persists it under .cache/ctmpl/ and a fresh process (here:
    a fresh CommitmentKey object) loads it instead of re-running the
    full-width one-shot MSM (cold-start persistence)."""
    import glob
    import random

    import jax.numpy as jnp

    from mira_tpu.fields.limbs import ints_to_limbs, limb_field
    from mira_tpu.table.packed import DeviceWitness

    rng = random.Random(11)
    curve = BN254_G1
    num_cols, nrow = 2, 32
    n = num_cols * nrow
    d = str(tmp_path / "ck")
    ck = CommitmentKey.load_or_setup_cache(curve, 6, "persist", cache_dir=d)
    lf = limb_field(curve.scalar_modulus)

    template_vals = [rng.randrange(curve.scalar_modulus) for _ in range(n)]
    template_raw16 = ints_to_limbs(template_vals)
    template_mont = lf.encode(template_vals)
    positions_np = np.asarray(sorted(rng.sample(range(n), 10)), dtype=np.int64)
    positions = jnp.asarray(positions_np, dtype=jnp.int32)
    new_vals = [rng.randrange(curve.scalar_modulus) for _ in positions_np]

    class _Tok:
        packed_template = template_raw16

    dw = DeviceWitness(
        lf, _Tok(), template_mont, template_mont[positions],
        positions, positions_np, jnp.asarray(ints_to_limbs(new_vals)),
        num_cols, nrow,
    )
    want = list(template_vals)
    for p, v in zip(positions_np, new_vals):
        want[int(p)] = v
    assert ck.commit_delta(dw) == ck.commit_ints(want)
    saved = glob.glob(str(tmp_path / "ctmpl" / "**" / "ctmpl-*.npy"),
                      recursive=True)
    assert saved, "template commitment not persisted"

    # fresh key object (second process analog): must LOAD the persisted
    # template commitment and still agree
    ck2 = CommitmentKey.load_or_setup_cache(curve, 6, "persist", cache_dir=d)
    dw2 = DeviceWitness(
        lf, _Tok(), template_mont, template_mont[positions],
        positions, positions_np, jnp.asarray(ints_to_limbs(new_vals)),
        num_cols, nrow,
    )
    assert ck2.commit_delta(dw2) == ck.commit_ints(want)

    # corruption guard: flip a limb of the cached point -> off-curve ->
    # recomputed (not trusted)
    arr = np.load(saved[0])
    arr[0, 0] ^= 1
    np.save(saved[0], arr)
    ck3 = CommitmentKey.load_or_setup_cache(curve, 6, "persist", cache_dir=d)
    dw3 = DeviceWitness(
        lf, _Tok(), template_mont, template_mont[positions],
        positions, positions_np, jnp.asarray(ints_to_limbs(new_vals)),
        num_cols, nrow,
    )
    assert ck3.commit_delta(dw3) == ck.commit_ints(want)


def test_template_cache_keyed_by_htc_and_key(tmp_path):
    """Template commitments live under <label>-<htc>/<key digest>/: a key
    with other points (a stale or foreign cache) never reads them."""
    d = str(tmp_path / "ck")
    ck = CommitmentKey.load_or_setup_cache(BN254_G1, 4, "keyed", cache_dir=d)
    path = ck._aux_path("ctmpl-x.npy")
    assert os.sep + "keyed-svdw" + os.sep in path
    ck._aux_save("ctmpl-x.npy", np.arange(3, dtype=np.uint32))
    assert ck._aux_load("ctmpl-x.npy") is not None
    other = CommitmentKey(BN254_G1, ck._limbs[::-1].copy())
    other._aux_dir = ck._aux_dir
    assert other._aux_path("ctmpl-x.npy") != path
    assert other._aux_load("ctmpl-x.npy") is None


@pytest.mark.parametrize("curve", [BN254_G1, GRUMPKIN], ids=lambda c: c.name)
def test_lane_msm_adversarial_lanes(curve):
    """ops/msm.py (the XLA route) against the host MSM on duplicate
    (scalar, point) pairs, a repeated point, opposite points, zero scalars
    and an identity lane."""
    import random

    from mira_tpu.curves.host import msm_host
    from mira_tpu.curves.jax_curve import jacobian_ops
    from mira_tpu.ops.msm import encode_scalars, msm_device

    rng = random.Random(31)
    r = curve.scalar_modulus
    base = [AffinePoint.random(curve, rng) for _ in range(4)]
    pts = [base[0], base[0], base[1], base[1], base[2], base[2].neg(),
           AffinePoint.identity(curve), base[3]]
    sc = [rng.randrange(r) for _ in pts]
    sc[1] = sc[0]  # exact duplicate pair
    sc[7] = 0
    ops = jacobian_ops(curve.name)
    with forced("msm", "xla"):
        out = msm_device(encode_scalars(sc, r), ops.encode_points(pts), curve)
    got = ops.decode_points(tuple(c[None] for c in out))[0]
    assert got == msm_host(sc, pts)


def test_commit_device_many_device_route_matches_host():
    """The batched dispatch/decode of commit_device_many on a device route
    (forced to the XLA lane MSM here) equals the host commitments."""
    import random

    from mira_tpu.fields.limbs import limb_field

    rng = random.Random(3)
    ck = CommitmentKey.setup(BN254_G1, 3, b"many")
    lf = limb_field(BN254_G1.scalar_modulus)
    vecs = [[rng.randrange(BN254_G1.scalar_modulus) for _ in range(n)]
            for n in (8, 5)]
    with forced("msm", "xla"):
        decode = ck.commit_device_many([lf.encode(v) for v in vecs],
                                       defer=True)
        got = decode()
    assert got == [ck.commit_ints(v) for v in vecs]
