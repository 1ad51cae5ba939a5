"""Native C++ fold evaluator — the CPU runtime path of commit_cross_terms.

Runs the op list of fold_evaluator.compile_ops (common subexpressions shared,
the reference's GraphEvaluator design,
/root/reference/src/polynomial/graph_evaluator.rs:196+, which dedups
constants/rotations/intermediates into `Calculation` ops) row-parallel in
native/evaluator.cpp — 4x64-bit __int128 Montgomery arithmetic, threads over
row chunks (the rayon analog).

The GPU runs the same op list on the device (fold_evaluator.py); this VM
exists because XLA:CPU executes the vectorized 16-bit-limb CIOS graphs
slowly, while scalar __int128 Montgomery runs the same rows far faster.

Field layout at the ABI: little-endian 4x64 Montgomery limbs — the byte
image of the device's (.., 16) 16-bit-limb uint32 arrays after dropping
the upper halves, so conversion is a numpy view, not arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..fields.limbs import LIMB_BITS, NUM_LIMBS
from ..fields.native64 import limbs16_to_64, limbs64_to_16
from ..utils.native_lib import available, load as _load  # noqa: F401
from .evaluator import advice_round_col
from .expression import Expression
from .fold_evaluator import (
    _split_scalar_subtrees,
    compile_ops,
    point_challenges,
    query_layout,
)

_MONT_R = 1 << (LIMB_BITS * NUM_LIMBS)


class NativeFoldEvaluator:
    """Multi-point fold evaluation on the native VM.

    Same query layout, scalar-subtree split and op list as FoldEvaluator."""

    def __init__(
        self,
        expr: Expression,
        modulus: int,
        num_advice: int,
        num_lookup: int,
        selectors: Sequence[Sequence[bool]],
        fixed: Sequence[Sequence[int]],
        nrow: int,
    ):
        self.expr = expr
        self.modulus = modulus
        self.num_advice = num_advice
        self.nrow = nrow
        self.qslot, self.advice_idx_rot, static_cols = query_layout(
            expr, num_advice, num_lookup, selectors, fixed, nrow
        )

        # Montgomery-encode static cols host-side into (n_sq, nrow, 4) u64
        n_sq = max(len(static_cols), 1)
        self.static64 = np.zeros((n_sq, nrow, 4), dtype=np.uint64)
        for s, col in enumerate(static_cols):
            for r, v in enumerate(col):
                if v:
                    mv = (v % modulus) * _MONT_R % modulus
                    for k in range(4):
                        self.static64[s, r, k] = (mv >> (64 * k)) & (
                            0xFFFFFFFFFFFFFFFF
                        )
        self._split_cache = {}
        self._ops_cache = {}

    def _split(self, n_ch_base: int):
        if n_ch_base not in self._split_cache:
            self._split_cache[n_ch_base] = _split_scalar_subtrees(
                self.expr, n_ch_base
            )
        return self._split_cache[n_ch_base]

    def _ops(self, n_ch_base: int):
        if n_ch_base not in self._ops_cache:
            rewritten, _ = self._split(n_ch_base)
            self._ops_cache[n_ch_base] = compile_ops(
                rewritten, self.qslot, self.modulus
            )
        return self._ops_cache[n_ch_base]

    def _stack64(self, Ws) -> np.ndarray:
        """Round vectors ((len, 16) u32 each) -> (n_aq, nrow, 4) u64."""
        nrow = self.nrow
        metas = [
            (*advice_round_col(self.num_advice, idx, len(Ws)), rot)
            for idx, rot in self.advice_idx_rot
        ]
        Ws64 = [limbs16_to_64(w) for w in Ws]
        n_aq = max(len(metas), 1)
        out = np.zeros((n_aq, nrow, 4), dtype=np.uint64)
        for a, (rnd, colj, rot) in enumerate(metas):
            col = Ws64[rnd][colj * nrow : (colj + 1) * nrow]
            out[a] = np.roll(col, -rot, axis=0) if rot else col
        return out

    def fold_eval_multi(self, W1s, W2s, j_values: Sequence[int],
                        ch1: Sequence[int], ch2: Sequence[int],
                        as64: bool = False):
        """Returns (n_j, nrow, 16) uint32 Montgomery limb numpy array
        (or the raw (n_j, nrow, 4) uint64 buffer when as64)."""
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "the native row VM (native/evaluator.cpp) did not build: "
                "the fold_eval route needs g++"
            )
        p = self.modulus
        nrow = self.nrow
        n_j = len(j_values)
        n_ch_base = len(ch1)
        _, scalars = self._split(n_ch_base)
        op_arr, n_regs, c64 = self._ops(n_ch_base)

        w1 = self._stack64(tuple(W1s))
        w2 = self._stack64(tuple(W2s))

        def enc64(vals):
            out = np.zeros((len(vals), 4), dtype=np.uint64)
            for i, v in enumerate(vals):
                mv = (v % p) * _MONT_R % p
                for k in range(4):
                    out[i, k] = (mv >> (64 * k)) & 0xFFFFFFFFFFFFFFFF
            return out

        ch_rows = point_challenges(j_values, ch1, ch2, scalars, p)
        n_ch = max(n_ch_base + len(scalars), 1)
        ch64 = enc64([v for row in ch_rows for v in row]) if ch_rows and \
            ch_rows[0] else np.zeros((n_j, 4), dtype=np.uint64)
        jm64 = enc64([j % p for j in j_values])

        mod64 = enc64([0])  # placeholder; fill with plain modulus limbs
        for k in range(4):
            mod64[0, k] = (p >> (64 * k)) & 0xFFFFFFFFFFFFFFFF

        out = np.zeros((n_j, nrow, 4), dtype=np.uint64)

        def ptr(a, ty=ctypes.c_uint64):
            return a.ctypes.data_as(ctypes.POINTER(ty))

        lib.mira_eval_fold(
            ptr(mod64),
            ptr(op_arr, ctypes.c_int32),
            op_arr.shape[0],
            n_regs,
            ptr(self.static64),
            ptr(w1),
            ptr(w2),
            ptr(np.ascontiguousarray(ch64)),
            n_ch,
            ptr(jm64),
            n_j,
            nrow,
            ptr(c64),
            0,
            ptr(out),
        )
        return out if as64 else limbs64_to_16(out)
