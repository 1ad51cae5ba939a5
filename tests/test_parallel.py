"""Multi-chip (virtual 8-device CPU mesh) vs single-chip equality —
the substitute for distributed tests per SURVEY.md §4."""

import random

import jax
import pytest

from mira_tpu.curves.host import BN254_G1, AffinePoint, msm_host
from mira_tpu.curves.jax_curve import jacobian_ops
from mira_tpu.fields.limbs import limb_field
from mira_tpu.fields.params import BN254_FR
from mira_tpu.ops.msm import encode_scalars
from mira_tpu.ops.ntt import ntt
from mira_tpu.parallel.mesh import make_mesh
from mira_tpu.parallel.msm import sharded_msm
from mira_tpu.parallel.ntt import distributed_ntt

LF = limb_field(BN254_FR)

needs_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_8_devices
def test_distributed_ntt_matches_single():
    mesh = make_mesh(8)
    rng = random.Random(0)
    n = 1 << 10
    vals = [rng.randrange(BN254_FR) for _ in range(n)]
    a = LF.encode(vals)
    single = LF.decode(ntt(a, BN254_FR))
    multi = LF.decode(distributed_ntt(a, BN254_FR, mesh))
    assert multi == single


@needs_8_devices
def test_distributed_intt_roundtrip():
    mesh = make_mesh(8)
    rng = random.Random(1)
    n = 1 << 8
    vals = [rng.randrange(BN254_FR) for _ in range(n)]
    a = LF.encode(vals)
    back = LF.decode(
        distributed_ntt(distributed_ntt(a, BN254_FR, mesh), BN254_FR, mesh, inverse=True)
    )
    assert back == vals


@needs_8_devices
def test_sharded_msm_matches_host():
    mesh = make_mesh(8)
    rng = random.Random(2)
    n = 16
    pts = [AffinePoint.random(BN254_G1, rng) for _ in range(n)]
    scalars = [rng.randrange(BN254_G1.scalar_modulus) for _ in range(n)]
    ops = jacobian_ops("bn254")
    sc = encode_scalars(scalars, BN254_G1.scalar_modulus)
    enc = ops.encode_points(pts)
    out = sharded_msm(sc, enc, BN254_G1, mesh, method="xla")
    got = ops.decode_points(tuple(c[None] for c in out))[0]
    assert got == msm_host(scalars, pts)


@needs_8_devices
def test_sharded_msm_native_matches_host():
    """CPU-mesh default: per-shard native C++ Pippenger via pure_callback +
    the same all-gather/tree-reduction mesh program as the GPU path."""
    from mira_tpu.ops.native_msm import available

    if not available():
        pytest.skip("no native toolchain")
    mesh = make_mesh(8)
    rng = random.Random(4)
    n = 64
    pts = [AffinePoint.random(BN254_G1, rng) for _ in range(n)]
    pts[5] = AffinePoint.identity(BN254_G1)  # infinity lane
    scalars = [rng.randrange(BN254_G1.scalar_modulus) for _ in range(n)]
    scalars[9] = 0  # zero-scalar lane
    ops = jacobian_ops("bn254")
    sc = encode_scalars(scalars, BN254_G1.scalar_modulus)
    enc = ops.encode_points(pts)
    out = sharded_msm(sc, enc, BN254_G1, mesh, method="native")
    got = ops.decode_points(tuple(c[None] for c in out))[0]
    assert got == msm_host(scalars, pts)


@pytest.mark.gpu
def test_sharded_msm_cuda_matches_host(gpu):
    """GPU route: per-shard CUDA bucket Pippenger + all-gather tree
    reduction, on every visible card."""
    mesh = make_mesh()
    rng = random.Random(3)
    n = 32 * mesh.devices.size
    pts = [AffinePoint.random(BN254_G1, rng) for _ in range(n)]
    scalars = [rng.randrange(BN254_G1.scalar_modulus) for _ in range(n)]
    ops = jacobian_ops("bn254")
    sc = encode_scalars(scalars, BN254_G1.scalar_modulus)
    enc = ops.encode_points(pts)
    out = sharded_msm(sc, enc, BN254_G1, mesh, method="cuda")
    got = ops.decode_points(tuple(c[None] for c in out))[0]
    assert got == msm_host(scalars, pts)


def test_sharded_msm_host_matches_host():
    """Host-threaded shard engine (parallel/msm.sharded_msm_host — the CPU
    scaling-harness path) == naive host MSM."""
    import random

    import numpy as np
    import pytest

    from mira_tpu.curves.host import BN254_G1, AffinePoint, msm_host
    from mira_tpu.curves.jax_curve import jacobian_ops
    from mira_tpu.ops.msm import encode_scalars
    from mira_tpu.ops.native_msm import available
    from mira_tpu.parallel.msm import sharded_msm_host

    if not available():
        pytest.skip("native MSM library unavailable")
    rng = random.Random(23)
    n = 64
    pts = [AffinePoint.random(BN254_G1, rng) for _ in range(n)]
    svals = [rng.randrange(BN254_G1.scalar_modulus) for _ in range(n)]
    svals[0] = 0
    sc = np.asarray(encode_scalars(svals, BN254_G1.scalar_modulus))
    enc = tuple(np.asarray(c) for c in jacobian_ops("bn254").encode_points(pts))
    got = sharded_msm_host(sc, enc, BN254_G1, 4)
    want = msm_host(svals, pts)
    assert (got.x.v, got.y.v) == (want.x.v, want.y.v)
