"""Branch-free Jacobian curve arithmetic on limb planes (device side).

Points are (X, Y, Z) limb arrays in Montgomery form; Z == 0 encodes the
identity.  All group-law cases (identity operands, doubling, inverses) are
resolved with masked selects so the kernels stay branch-free — the vector
replacement for the reference's scalar Rust group ops that feed
`best_multiexp` (/root/reference/src/commitment.rs:78-87).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from ..curves.host import AffinePoint, CurveParams
from ..fields.limbs import NUM_LIMBS, limb_field


class JacobianOps:
    """Group-law kernels for one curve (a = 0, y^2 = x^3 + b)."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.lf = limb_field(curve.base_modulus)

    # -- host <-> device ----------------------------------------------------
    def encode_points(self, points):
        """List of AffinePoint -> (X, Y, Z) limb arrays (Z=0 for identity)."""
        xs = [0 if p.is_inf else p.x.v for p in points]
        ys = [0 if p.is_inf else p.y.v for p in points]
        zs = [0 if p.is_inf else 1 for p in points]
        return (self.lf.encode(xs), self.lf.encode(ys), self.lf.encode(zs))

    def decode_points(self, pt):
        """(X, Y, Z) limb arrays -> list of AffinePoint."""
        from ..fields.host import field

        F = field(self.curve.base_modulus)
        n = pt[0].shape[0]
        if n <= 64:
            # tiny batches (MSM results): from-Montgomery in host python —
            # lf.decode would dispatch a device CIOS + sync PER coordinate,
            # three device round trips for 16 limbs of data
            import numpy as np

            from ..fields.limbs import limbs_to_int

            p = self.curve.base_modulus
            rinv = pow(1 << (16 * NUM_LIMBS), -1, p)
            arrs = [np.asarray(c) for c in pt]
            xs, ys, zs = (
                [(limbs_to_int(row) * rinv) % p for row in a] for a in arrs
            )
            out = []
            for x, y, z in zip(xs, ys, zs):
                if z == 0:
                    out.append(AffinePoint.identity(self.curve))
                else:
                    zinv = pow(z, -1, p)
                    zi2 = (zinv * zinv) % p
                    out.append(
                        AffinePoint(self.curve, F(x * zi2), F(y * zi2 * zinv))
                    )
            return out
        xs, ys, zs = (self.lf.decode(c) for c in pt)
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(AffinePoint.identity(self.curve))
            else:
                zinv = pow(z, -1, self.curve.base_modulus)
                zi2 = (zinv * zinv) % self.curve.base_modulus
                out.append(
                    AffinePoint(
                        self.curve,
                        F(x * zi2),
                        F(y * zi2 * zinv),
                    )
                )
        return out

    def identity(self, shape=()):
        lf = self.lf
        return (lf.zero(shape), lf.one(shape), lf.zero(shape))

    # -- group law ----------------------------------------------------------
    def double(self, p):
        """Jacobian doubling for a=0 curves (2M + 5S)."""
        lf = self.lf
        X, Y, Z = p
        A = lf.square(X)
        B = lf.square(Y)
        C = lf.square(B)
        # D = 2*((X+B)^2 - A - C)
        t = lf.square(lf.add(X, B))
        D = lf.double(lf.sub(lf.sub(t, A), C))
        E = lf.add(lf.double(A), A)  # 3A
        F_ = lf.square(E)
        X3 = lf.sub(F_, lf.double(D))
        Y3 = lf.sub(lf.mul(E, lf.sub(D, X3)), lf.double(lf.double(lf.double(C))))
        Z3 = lf.double(lf.mul(Y, Z))
        # identity doubles to identity (Z=0 propagates through Z3 = 2YZ = 0)
        return (X3, Y3, Z3)

    def add(self, p, q):
        """Complete Jacobian addition via masked selects.

        Handles p or q identity, p == q (doubling), p == -q (identity).
        """
        lf = self.lf
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = lf.square(Z1)
        Z2Z2 = lf.square(Z2)
        U1 = lf.mul(X1, Z2Z2)
        U2 = lf.mul(X2, Z1Z1)
        S1 = lf.mul(lf.mul(Y1, Z2), Z2Z2)
        S2 = lf.mul(lf.mul(Y2, Z1), Z1Z1)
        H = lf.sub(U2, U1)
        R = lf.sub(S2, S1)
        HH = lf.square(H)
        HHH = lf.mul(H, HH)
        V = lf.mul(U1, HH)
        X3 = lf.sub(lf.sub(lf.square(R), HHH), lf.double(V))
        Y3 = lf.sub(lf.mul(R, lf.sub(V, X3)), lf.mul(S1, HHH))
        Z3 = lf.mul(lf.mul(Z1, Z2), H)

        p_inf = lf.is_zero(Z1)
        q_inf = lf.is_zero(Z2)
        h_zero = lf.is_zero(H)
        r_zero = lf.is_zero(R)
        is_double = h_zero & r_zero & ~p_inf & ~q_inf
        is_opposite = h_zero & ~r_zero & ~p_inf & ~q_inf

        dX, dY, dZ = self.double((X1, Y1, Z1))

        def sel(c, a, b):
            return lf.select(c, a, b)

        zero = lf.zero(X3.shape[:-1])
        one = lf.one(X3.shape[:-1])
        X3 = sel(is_opposite, zero, sel(is_double, dX, X3))
        Y3 = sel(is_opposite, one, sel(is_double, dY, Y3))
        Z3 = sel(is_opposite, zero, sel(is_double, dZ, Z3))
        X3 = sel(p_inf, X2, sel(q_inf, X1, X3))
        Y3 = sel(p_inf, Y2, sel(q_inf, Y1, Y3))
        Z3 = sel(p_inf, Z2, sel(q_inf, Z1, Z3))
        return (X3, Y3, Z3)

    def select(self, mask, p, q):
        lf = self.lf
        return tuple(lf.select(mask, a, b) for a, b in zip(p, q))

    def neg(self, p):
        X, Y, Z = p
        return (X, self.lf.neg(Y), Z)

    def tree_sum(self, p, axis=0):
        """Sum points along an axis via a halving tree of adds."""
        pt = tuple(jnp.moveaxis(c, axis, 0) for c in p)
        while pt[0].shape[0] > 1:
            n = pt[0].shape[0]
            half = n // 2
            lo = tuple(c[:half] for c in pt)
            hi = tuple(c[half : 2 * half] for c in pt)
            s = self.add(lo, hi)
            if n % 2:
                last = tuple(c[-1:] for c in pt)
                first = tuple(c[:1] for c in s)
                merged = self.add(first, last)
                s = tuple(
                    jnp.concatenate([m, c[1:]], axis=0) for m, c in zip(merged, s)
                )
            pt = s
        return tuple(c[0] for c in pt)


@lru_cache(maxsize=None)
def jacobian_ops(curve_name: str) -> JacobianOps:
    from ..curves.host import BN254_G1, GRUMPKIN

    return JacobianOps(BN254_G1 if curve_name == "bn254" else GRUMPKIN)
