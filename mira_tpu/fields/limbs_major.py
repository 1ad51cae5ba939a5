"""Montgomery add and multiply in the limbs-major (16, B) layout.

The device fold evaluator (polynomial/fold_evaluator.py) keeps every
column as a (16, nrow) array: limb i of all rows is one contiguous row, so
each step of a multiply is a whole-row elementwise op that XLA fuses.  Same
arithmetic as fields/limbs.LimbField (R = 2^256, canonical values), in the
transposed layout.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from .limbs import LIMB_BITS, MASK, NUM_LIMBS, int_to_limbs


class TField:
    """Field constants + ops for the transposed (16, B) layout."""

    def __init__(self, modulus: int):
        assert modulus < 1 << (LIMB_BITS * NUM_LIMBS - 2), "need 4p <= R"
        self.modulus = modulus
        # per-limb python ints: tiles are built from scalar literals
        self.p_limbs = [int(v) for v in int_to_limbs(modulus)]
        self.n0inv = np.uint32((-pow(modulus, -1, 1 << LIMB_BITS)) & MASK)

    def _tile(self, limbs, B):
        shape = (B,) if isinstance(B, int) else tuple(B)
        return jnp.stack(
            [jnp.full(shape, v, jnp.uint32) for v in limbs], axis=0
        )

    def p_tile(self, B):
        return self._tile(self.p_limbs, B)

    # -- helpers -------------------------------------------------------------
    def _normalize17(self, acc):
        """(17, B) lazy columns -> rippled (17, B) with rows < 2^16."""
        rows = [acc[i] for i in range(17)]
        for i in range(16):
            carry = rows[i] >> LIMB_BITS
            rows[i] = rows[i] & MASK
            rows[i + 1] = rows[i + 1] + carry
        return jnp.stack(rows, axis=0)

    def _geq(self, a, b):
        """(16, B) >= (16, B) lexicographically -> (B,) uint32 0/1 flag."""
        res = jnp.ones(a.shape[1:], dtype=jnp.uint32)
        for i in range(NUM_LIMBS):
            res = jnp.where(a[i] > b[i], jnp.uint32(1),
                            jnp.where(a[i] < b[i], jnp.uint32(0), res))
        return res

    def _sub16(self, a, b):
        """(a - b) rows, assuming a >= b."""
        rows = []
        borrow = jnp.zeros(a.shape[1:], dtype=jnp.uint32)
        for i in range(a.shape[0]):
            d = a[i] + (MASK + 1) - b[i] - borrow
            rows.append(d & MASK)
            borrow = 1 - (d >> LIMB_BITS)
        return jnp.stack(rows, axis=0)

    def _cond_sub_p(self, acc17):
        B = acc17.shape[1:]
        p17 = jnp.concatenate(
            [self.p_tile(B), jnp.zeros((1,) + B, jnp.uint32)], axis=0
        )
        # One round suffices: inputs stay < p, so sums are < 2p and
        # Montgomery outputs T = (ab + mp)/R < p^2/R + p < 2p.
        ge = self._geq(acc17, p17)
        sub = self._sub16(acc17, p17)
        m = (jnp.uint32(0) - ge)[None, :]
        acc17 = (sub & m) | (acc17 & ~m)
        return acc17[:NUM_LIMBS]

    # -- ring ops ------------------------------------------------------------
    def add(self, a, b):
        acc = jnp.concatenate(
            [a + b, jnp.zeros((1,) + a.shape[1:], jnp.uint32)], axis=0
        )
        return self._cond_sub_p(self._normalize17(acc))

    def mul(self, a, b):
        """CIOS Montgomery, fully unrolled over lists of (B,) limb rows with
        lazy carries: every op is elementwise on whole rows, which XLA:GPU
        fuses into fewer kernels than a (16, B) tile form with row rotates
        (215 against 373 us per (16, 2^17) multiply on an H100).  Each row
        gains < 2^18 per iteration and lives <= 16 shifts, so rows stay
        < 2^23."""
        shp = jnp.broadcast_shapes(a.shape, b.shape)[1:]
        ar = [jnp.broadcast_to(a[i], shp) for i in range(NUM_LIMBS)]
        br = [jnp.broadcast_to(b[i], shp) for i in range(NUM_LIMBS)]
        zero = jnp.zeros(shp, jnp.uint32)
        t = [zero] * (NUM_LIMBS + 1)
        for i in range(NUM_LIMBS):
            for j in range(NUM_LIMBS):
                prod = ar[i] * br[j]
                t[j] = t[j] + (prod & MASK)
                t[j + 1] = t[j + 1] + (prod >> LIMB_BITS)
            m = (t[0] * self.n0inv) & MASK
            for j in range(NUM_LIMBS):
                qp = m * np.uint32(self.p_limbs[j])
                t[j] = t[j] + (qp & MASK)
                t[j + 1] = t[j + 1] + (qp >> LIMB_BITS)
            t = [t[1] + (t[0] >> LIMB_BITS)] + t[2:] + [zero]
        return self._cond_sub_p(self._normalize17(jnp.stack(t, axis=0)))


@lru_cache(maxsize=None)
def tfield(modulus: int) -> TField:
    return TField(modulus)
