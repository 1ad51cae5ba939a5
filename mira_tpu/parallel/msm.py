"""Multi-device MSM: points/scalars sharded across the mesh, per-shard
partial MSMs combined with an all-gather + local Jacobian tree reduction.

The per-shard engine is the platform's MSM route (routes.py): the CUDA
bucket Pippenger on each GPU, the native host Pippenger through
pure_callback on a CPU mesh, or the lane double-and-add of ops/msm.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..curves.host import CurveParams
from ..curves.jax_curve import jacobian_ops
from ..fields.limbs import LIMB_BITS, NUM_LIMBS
from .mesh import AXIS


def _lane_msm(ops, scalars, pts, num_bits):
    """Per-shard lane double-and-add (same algorithm as ops/msm._msm_jit)."""
    n = pts[0].shape[0]

    def bit_of(b):
        limb = jax.lax.dynamic_index_in_dim(
            scalars, b // LIMB_BITS, axis=1, keepdims=False
        )
        return (limb >> (b % LIMB_BITS)) & 1

    def body(i, acc):
        b = num_bits - 1 - i
        acc = ops.double(acc)
        added = ops.add(acc, pts)
        take = bit_of(b) > 0
        return ops.select(take, added, acc)

    acc = jax.lax.fori_loop(0, num_bits, body, ops.identity((n,)))

    log_n = max((n - 1).bit_length(), 1)

    def red(k, a):
        half = jnp.left_shift(jnp.int32(1), log_n - 1 - k)
        idx = jnp.arange(n, dtype=jnp.int32)
        partner = tuple(c[jnp.minimum(idx + half, n - 1)] for c in a)
        merged = ops.add(a, partner)
        keep = idx < half
        return ops.select(keep, merged, a)

    acc = jax.lax.fori_loop(0, log_n, red, acc)
    return tuple(c[:1] for c in acc)


def _native_shard_callback(curve):
    """Per-shard host MSM via the native C++ Pippenger, wrapped for
    jax.pure_callback: Montgomery limb shards in, a Montgomery Jacobian
    partial out.  This is the CPU-host analog of the per-shard CUDA
    kernel — the mesh program (sharding + all_gather + tree reduction)
    stays identical to the GPU path, only the local engine differs, the
    same way the reference's rayon sits under its MSM
    (/root/reference/src/commitment.rs:78-87)."""
    import numpy as np

    from ..fields.native64 import (
        from_mont16,
        limbs16_to_64,
        limbs64_to_16,
        to_mont,
    )
    from ..ops.native_msm import msm_native_raw

    p = curve.base_modulus

    def cb(scalars, X, Y, Z):
        sc64 = limbs16_to_64(np.asarray(scalars, dtype=np.uint32))
        x_pl = limbs16_to_64(from_mont16(p, np.asarray(X, dtype=np.uint32)))
        y_pl = limbs16_to_64(from_mont16(p, np.asarray(Y, dtype=np.uint32)))
        z_pl = limbs16_to_64(from_mont16(p, np.asarray(Z, dtype=np.uint32)))
        # precondition: affine (z == 1) or infinity (z == 0) lanes only —
        # every sharded caller feeds commitment-key/affine-encoded points
        is_inf = ~z_pl.any(axis=1)
        is_one = (z_pl[:, 0] == 1) & ~z_pl[:, 1:].any(axis=1)
        if not bool(np.all(is_inf | is_one)):
            raise ValueError("native shard MSM requires affine points")
        if bool(is_inf.any()):
            sc64 = np.where(is_inf[:, None], 0, sc64)
            x_pl = np.where(is_inf[:, None], 0, x_pl)
            y_pl = np.where(is_inf[:, None], 0, y_pl)
        # one thread per shard: the mesh devices ARE the parallelism (auto
        # threading oversubscribes ndev x ncores and poisons scaling numbers)
        jac = msm_native_raw(sc64, x_pl, y_pl, p, nthreads=1)  # (3,4) u64
        out = limbs64_to_16(to_mont(p, jac.astype(np.uint64)))
        return (
            out[0:1].astype(np.uint32),
            out[1:2].astype(np.uint32),
            out[2:3].astype(np.uint32),
        )

    return cb


@lru_cache(maxsize=None)
def _sharded_msm_jit(curve_name: str, num_bits: int, mesh: Mesh, method: str):
    ops = jacobian_ops(curve_name)
    from ..curves.host import BN254_G1, GRUMPKIN

    curve = BN254_G1 if curve_name == "bn254" else GRUMPKIN
    if method == "cuda":
        from ..ops.cuda_msm import msm_cuda
    if method == "native":
        native_cb = _native_shard_callback(curve)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS), (P(AXIS), P(AXIS), P(AXIS))),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(scalars, pts):
        if method == "cuda":
            # per-shard bucket Pippenger on each device's own card
            part = tuple(c[None] for c in msm_cuda(scalars, pts, curve))
        elif method == "native":
            import jax.numpy as jnp

            shape = jax.ShapeDtypeStruct((1, NUM_LIMBS), jnp.uint32)
            part = jax.pure_callback(
                native_cb, (shape, shape, shape), scalars, *pts
            )
        else:
            part = _lane_msm(ops, scalars, pts, num_bits)  # triple of (1, L)
        # gather all shards' partials and tree-reduce locally (point addition
        # is not a psum-able monoid for XLA, so gather + local combine)
        gathered = tuple(
            jax.lax.all_gather(c[0], AXIS, tiled=False) for c in part
        )  # (ndev, L)
        return ops.tree_sum(gathered)

    return jax.jit(run)


def sharded_msm_host(scalars, points, curve: CurveParams, nshards: int):
    """Host-threaded shard engine: the same shard decomposition as
    sharded_msm with per-shard native C++ Pippenger partials (nthreads=1
    each) on a thread pool, and a host tree reduction.

    This is the CPU-host path of the SCALING harness: on this 4-core host,
    >=3 concurrent XLA:CPU pure_callbacks starve one another regardless of
    collectives (observed: device threads wedge inside the python
    callbacks; with a collective present its rendezvous then aborts the
    process), so the mesh-program route can't be timed at n>=4.  On a CPU
    "mesh" the virtual devices are host threads anyway — this measures the
    identical per-shard engine + reduction, the role rayon plays under the
    reference's best_multiexp (/root/reference/src/commitment.rs:66-87).
    The device scaling path (per-shard CUDA kernels + mesh collectives)
    is sharded_msm on a GPU mesh.

    Returns a host AffinePoint."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    cb = _native_shard_callback(curve)
    sc = np.asarray(scalars)
    X, Y, Z = (np.asarray(c) for c in points)
    n = sc.shape[0]
    assert n % nshards == 0
    m = n // nshards

    def shard(i):
        sl = slice(i * m, (i + 1) * m)
        return cb(sc[sl], X[sl], Y[sl], Z[sl])

    with ThreadPoolExecutor(max_workers=nshards) as ex:
        parts = list(ex.map(shard, range(nshards)))
    acc = None
    for px, py, pz in parts:
        pt = ops_decode(curve, (px, py, pz))
        acc = pt if acc is None else acc.add(pt)
    return acc


def ops_decode(curve, triple):
    from ..curves.jax_curve import jacobian_ops

    return jacobian_ops(curve.name).decode_points(triple)[0]


def sharded_msm(scalars, points, curve: CurveParams, mesh: Mesh,
                method: str | None = None):
    """scalars: (N,16) plain limbs; points: (X,Y,Z) Montgomery limb arrays.
    N must divide evenly across the mesh. Returns a Jacobian triple.

    method (default: the platform's msm route) picks the per-shard engine:
    "cuda" runs the bucket Pippenger on each GPU; "native" routes each shard
    through the C++ host Pippenger via pure_callback (CPU meshes — same
    mesh program, host-appropriate local engine); "xla" is the lane
    double-and-add."""
    from ..routes import route

    if method is None:
        method = route("msm")
    num_bits = curve.scalar_modulus.bit_length()
    return _sharded_msm_jit(curve.name, num_bits, mesh, method)(
        scalars, points
    )
