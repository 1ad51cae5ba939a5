"""Homomorphic mock commitment key for CPU tests.

commit(v) = G * (<weights, v> mod r) — linear in v, so every folding identity
(W' = W1 + r*W2, E' = E + sum r^k T_k) holds exactly as with the real Pedersen
key, at the cost of one inner product + one scalar-mul instead of an MSM.
NOT binding; strictly for tests where MSM throughput on CPU would dominate.
"""

from __future__ import annotations

import hashlib
from typing import List

from ..curves.host import AffinePoint, CurveParams
from ..fields.limbs import limb_field, limbs_to_ints


class MockCommitmentKey:
    def __init__(self, curve: CurveParams, k: int, label: bytes = b"mock"):
        self.curve = curve
        self.size = 1 << k
        r = curve.scalar_modulus
        # deterministic weight stream
        seed = hashlib.shake_256(b"mira-mock-ck" + label).digest(16 * self.size)
        self.weights = [
            int.from_bytes(seed[16 * i : 16 * (i + 1)], "little") % r
            for i in range(self.size)
        ]
        self._gen = AffinePoint.generator(curve)

    def __len__(self):
        return self.size

    @property
    def points(self):
        raise AttributeError("mock key has no point table")

    def commit_ints(self, values: List[int]) -> AffinePoint:
        if len(values) > self.size:
            raise ValueError("input too long")
        r = self.curve.scalar_modulus
        acc = 0
        for w, v in zip(self.weights, values):
            acc += w * v
        return self._gen.scalar_mul(acc % r)

    def commit_delta(self, dw) -> AffinePoint:
        """DeviceWitness path: the mock key has no point table to gather, so
        just commit the scattered full witness."""
        return self.commit_device(dw.encode_mont(dw.lf))

    def commit_device(self, witness_mont, mesh=None) -> AffinePoint:
        r = self.curve.scalar_modulus
        try:
            from ..fields.native64 import (
                available,
                inner_product_mont,
                ints_to_64,
                limbs16_to_64,
            )

            if available():
                # <weights, witness> on the native 4x64 Montgomery kernel:
                # mont_mul(w_plain, v_mont) = w*v, so no decode pass at all;
                # the witness side stays in its (n, 16) device layout
                # (fused pack inside the kernel)
                if not hasattr(self, "_weights64"):
                    self._weights64 = ints_to_64(self.weights)
                import numpy as np

                from ..fields.native64 import inner_product_mont16

                v16 = np.asarray(witness_mont)
                if v16.shape[0] > self.size:
                    raise ValueError("input too long")
                acc = inner_product_mont16(r, self._weights64, v16)
                return self._gen.scalar_mul(acc)
        except ImportError:  # pragma: no cover
            pass
        lf = limb_field(r)
        return self.commit_ints(lf.decode(witness_mont))
