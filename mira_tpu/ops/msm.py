"""Device multi-scalar multiplication.

`msm_device` takes the platform's device route (routes.py): the CUDA bucket
Pippenger (ops/cuda_msm.py) or the plain XLA lane MSM below.

The lane MSM (vs the reference's Pippenger `best_multiexp`,
/root/reference/src/commitment.rs:78-87) avoids data-dependent scatter:
every point lane runs MSB-first double-and-add on its own scalar (1 double +
1 masked add per bit over all lanes, a single small fori_loop body for XLA),
then a masked halving tree folds the N partial results.  It is fully SIMD
and its compile size is independent of N, at about 10x Pippenger's work.

Multi-device: see mira_tpu/parallel/msm (shard points across the mesh,
combine the per-shard partial sums).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from ..curves.host import AffinePoint, CurveParams
from ..curves.jax_curve import jacobian_ops
from ..fields.limbs import LIMB_BITS, NUM_LIMBS, ints_to_limbs


def encode_scalars(values, scalar_modulus: int) -> jnp.ndarray:
    """Scalars (ints / host field elements) -> PLAIN (non-Montgomery) limbs."""
    ints = [(v if isinstance(v, int) else v.v) % scalar_modulus for v in values]
    return jnp.asarray(ints_to_limbs(ints), dtype=jnp.uint32)


@lru_cache(maxsize=None)
def _msm_jit(curve_name: str, num_bits: int):
    ops = jacobian_ops(curve_name)
    lf = ops.lf

    def bit_of(scalars, b):
        limb = jax.lax.dynamic_index_in_dim(
            scalars, b // LIMB_BITS, axis=1, keepdims=False
        )
        return (limb >> (b % LIMB_BITS)) & 1

    def run(scalars, X, Y, Z):
        n = X.shape[0]
        pts = (X, Y, Z)

        def body(i, acc):
            b = num_bits - 1 - i
            acc = ops.double(acc)
            added = ops.add(acc, pts)
            take = bit_of(scalars, b) > 0
            return ops.select(take, added, acc)

        acc = jax.lax.fori_loop(0, num_bits, body, ops.identity((n,)))

        # masked halving reduction, fixed shapes (one add instance)
        log_n = max((n - 1).bit_length(), 1)
        pad = (1 << log_n) - n
        if pad:
            ident = ops.identity((pad,))
            acc = tuple(
                jnp.concatenate([c, jnp.broadcast_to(i_c, (pad, NUM_LIMBS))])
                for c, i_c in zip(acc, ident)
            )

        def red(k, a):
            half = jnp.left_shift(jnp.int32(1), log_n - 1 - k)
            idx = jnp.arange(1 << log_n, dtype=jnp.int32)
            partner = tuple(c[jnp.minimum(idx + half, (1 << log_n) - 1)] for c in a)
            merged = ops.add(a, partner)
            keep = idx < half
            return ops.select(keep, merged, a)

        acc = jax.lax.fori_loop(0, log_n, red, acc)
        return tuple(c[0] for c in acc)

    return jax.jit(run)


def msm(scalars, points, curve: CurveParams):
    """Device MSM: scalars (N,16) plain limbs, points (X,Y,Z) Montgomery limb
    arrays; returns a Jacobian triple of (16,) arrays."""
    num_bits = curve.scalar_modulus.bit_length()
    X, Y, Z = points
    return _msm_jit(curve.name, num_bits)(scalars, X, Y, Z)


def msm_device(scalars, points, curve: CurveParams):
    """MSM on the platform's device route; same operands and result as
    `msm`.  Points must be affine (Z = 1) or identities (Z = 0)."""
    from ..routes import route

    impl = route("msm")
    if impl == "cuda":
        from .cuda_msm import msm_cuda

        return msm_cuda(scalars, points, curve)
    if impl == "xla":
        return msm(scalars, points, curve)
    raise ValueError(f"msm route {impl!r} has no device MSM")


def msm_from_host(scalar_vals, affine_points, curve: CurveParams) -> AffinePoint:
    """Convenience host API: encode, run device MSM, decode to affine."""
    ops = jacobian_ops(curve.name)
    sc = encode_scalars(scalar_vals, curve.scalar_modulus)
    pts = ops.encode_points(affine_points)
    out = msm(sc, pts, curve)
    return ops.decode_points(tuple(c[None] for c in out))[0]
