"""Expression evaluation over circuit tables.

Two implementations with identical semantics:

* `eval_rows_host` — python-int row evaluation, the golden reference, mirrors
  the reference's interpreter semantics (graph_evaluator.rs + eval.rs)
  including the advice/lookup witness index mapping of
  `PlonkEvalDomain::eval_advice_var` (/root/reference/src/plonk/eval.rs:153-228)
  and rotations taken mod 2^k.

* `ColumnEvaluator` — the device path: evaluates whole columns at once on limb
  arrays (rotations are `jnp.roll`), one fused jitted program per expression.
  This replaces the reference's per-row interpreted loop
  (/root/reference/src/plonk/mod.rs:461-530) with the natural vector idiom.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.limbs import LimbField, limb_field
from .expression import Expression, Query


@dataclasses.dataclass
class EvalDomain:
    """Everything needed to resolve query indices.

    Witness layouts follow the reference:
    * W1s/W2s are per-round concatenated column vectors (column j of round i
      lives at W[i][j*nrow:(j+1)*nrow]).
    * challenges is the concatenation appropriate for the caller (e.g.
      [U1.challenges, u1, U2.challenges, u2] for cross terms).
    """

    modulus: int
    num_advice: int
    num_lookup: int
    challenges: List[int]
    selectors: List[List[bool]]
    fixed: List[List[int]]
    W1s: List[List[int]]
    W2s: List[List[int]]

    @property
    def nrow(self) -> int:
        if self.fixed:
            return len(self.fixed[0])
        if self.selectors:
            return len(self.selectors[0])
        raise ValueError("fixed & selectors both empty")

    def advice_round_col(self, index: int, num_witness: int):
        return advice_round_col(self.num_advice, index, num_witness)


def advice_round_col(num_advice: int, index: int, num_witness: int):
    """Map a fold-var index (within one instance) to (round, column)
    (reference eval.rs:170-204)."""
    if index < num_advice:
        return (0, index)
    lookup_index = (index - num_advice) // 5
    sub = (index - num_advice) % 5
    first_round, sub = (True, sub) if sub < 3 else (False, sub - 3)
    if num_witness == 2:
        if first_round:
            return (0, num_advice + lookup_index * 3 + sub)
        return (1, lookup_index * 2 + sub)
    if num_witness == 3:
        if first_round:
            return (1, lookup_index * 3 + sub)
        return (2, lookup_index * 2 + sub)
    raise ValueError(f"invalid num_witness {num_witness}")


def eval_rows_host(expr: Expression, data: EvalDomain,
                   rows: Optional[Sequence[int]] = None) -> List[int]:
    """Evaluate `expr` on every row (or on `rows`); returns python ints."""
    p = data.modulus
    nrow = data.nrow
    picked = range(nrow) if rows is None else list(rows)
    n = len(picked)
    max_width = data.num_advice + 5 * data.num_lookup
    n_sel, n_fix = len(data.selectors), len(data.fixed)

    def column(q: Query) -> List[int]:
        if q.index < n_sel:
            col = [1 if b else 0 for b in data.selectors[q.index]]
        elif q.index < n_sel + n_fix:
            col = data.fixed[q.index - n_sel]
        else:
            idx = q.index - n_sel - n_fix
            if idx < max_width:
                Ws, num_witness = data.W1s, len(data.W1s)
            else:
                idx -= max_width
                Ws, num_witness = data.W2s, len(data.W2s)
            rnd, colj = data.advice_round_col(idx, num_witness)
            col = Ws[rnd][colj * nrow : (colj + 1) * nrow]
        rot = q.rotation % nrow
        return [col[(r + rot) % nrow] for r in picked]

    out = expr.evaluate(
        constant=lambda c: [c % p] * n,
        poly=lambda q: column(q),
        challenge=lambda i: [data.challenges[i] % p] * n,
        negated=lambda a: [(-x) % p for x in a],
        sum_=lambda a, b: [(x + y) % p for x, y in zip(a, b)],
        product=lambda a, b: [(x * y) % p for x, y in zip(a, b)],
        scaled=lambda a, k: [(x * k) % p for x in a],
    )
    return out


class ColumnEvaluator:
    """Device column evaluation of one expression.

    Static data (selectors/fixed) is encoded once; witness rounds and
    challenges are passed per call as Montgomery limb arrays.  The expression
    is closed over at trace time, producing one fused XLA program.
    """

    def __init__(
        self,
        expr: Expression,
        modulus: int,
        num_advice: int,
        num_lookup: int,
        selectors: List[List[bool]],
        fixed: List[List[int]],
        nrow: int,
    ):
        self.expr = expr
        self.lf = limb_field(modulus)
        self.modulus = modulus
        self.num_advice = num_advice
        self.num_lookup = num_lookup
        self.nrow = nrow
        self.n_sel = len(selectors)
        self.n_fix = len(fixed)
        # encode static columns once (Montgomery); passed as jit ARGUMENTS,
        # not closed over — captured constants are embedded in the lowered
        # program (gigabytes at k=22) and break the compile cache
        self.static_cols = tuple(
            self.lf.encode([1 if b else 0 for b in col]) for col in selectors
        ) + tuple(self.lf.encode(col) for col in fixed)
        self._jit = jax.jit(self._run)

    def _resolve(self, q: Query, static_cols, W1s, W2s, challenges):
        lf = self.lf
        max_width = self.num_advice + 5 * self.num_lookup
        if q.index < self.n_sel + self.n_fix:
            col = static_cols[q.index]
        else:
            idx = q.index - self.n_sel - self.n_fix
            if idx < max_width:
                Ws, num_witness = W1s, len(W1s)
            else:
                idx -= max_width
                Ws, num_witness = W2s, len(W2s)
            rnd, colj = advice_round_col(self.num_advice, idx, num_witness)
            col = jax.lax.dynamic_slice_in_dim(
                Ws[rnd], colj * self.nrow, self.nrow, axis=0
            )
        rot = q.rotation % self.nrow
        if rot:
            col = jnp.roll(col, -rot, axis=0)
        return col

    def _run(self, static_cols, W1s, W2s, challenges):
        lf = self.lf
        shape = (self.nrow,)

        def const(c):
            return lf.const(c % self.modulus, shape)

        out = self.expr.evaluate(
            constant=const,
            poly=lambda q: self._resolve(q, static_cols, W1s, W2s, challenges),
            challenge=lambda i: jnp.broadcast_to(challenges[i], (self.nrow, 16)),
            negated=lf.neg,
            sum_=lf.add,
            product=lf.mul,
            scaled=lambda a, k: lf.mul(a, const(k)),
        )
        return out

    def __call__(self, W1s: Sequence, W2s: Sequence, challenges: Sequence[int]):
        """W1s/W2s: tuples of Montgomery limb arrays (round vectors);
        challenges: python ints.  Returns (nrow, 16) Montgomery limb array."""
        ch = self.lf.encode(list(challenges)) if challenges else self.lf.zero((0,))
        return self._jit(self.static_cols, tuple(W1s), tuple(W2s), ch)

    def fold_eval(self, W1s: Sequence, W2s: Sequence, j_mont, challenges_enc):
        """P(W1 + j*W2) with the witness RLC fused INTO the evaluator program.

        One jitted program serves every fold point j (j enters as a traced
        (1,16) Montgomery scalar): without this, the cross-term loop
        (nifs/vanilla.py) dispatched each CIOS step of the RLC as a separate
        eager XLA op over the full concatenated round vectors — ~97% of a
        SnarkStar fold step at k=19."""
        if not hasattr(self, "_fold_jit"):
            lf = self.lf

            def run(static_cols, W1r, W2r, jm, ch):
                Wj = tuple(
                    lf.add(a, lf.mul(jm, b)) for a, b in zip(W1r, W2r)
                )
                return self._run(static_cols, Wj, (), ch)

            self._fold_jit = jax.jit(run)
        return self._fold_jit(
            self.static_cols, tuple(W1s), tuple(W2s), j_mont, challenges_enc
        )
