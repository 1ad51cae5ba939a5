"""Plonkish structure, instances, witnesses and the folding objects.

Mirrors the type/protocol surface of the reference's
/root/reference/src/plonk/mod.rs re-designed for the device:

* witness rounds live on device as Montgomery limb arrays; commitments run
  through the device MSM; row-satisfaction checks and witness folding are
  fused column kernels;
* instance-side math (points, challenges, Gt elements) stays on host —
  it is O(1) per fold.

Protocol semantics preserved exactly: SPS rounds 0-3 with the reference's
absorb order (plonk/mod.rs:653-907), instance folding (plonk/mod.rs:979-1081)
including Mira's g1/g2/gt extensions, witness folding (plonk/mod.rs:1097-1134),
satisfaction checks (plonk/mod.rs:436-622).

NOTE: the reference currently fills `g1_elements`/`g2_elements` of fresh
instances with *random* placeholder points ("TODO(jbeal): Generate the correct
group elements", plonk/mod.rs:690-703).  We reproduce that structure with an
injectable RNG so tests are deterministic.
"""

from __future__ import annotations

import dataclasses
import random
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..curves.host import AffinePoint, CurveParams, G2Point, Tuple12
from ..fields.host import Fp, field, fe_to_fe
from ..fields.limbs import limb_field
from ..routes import route
from ..polynomial.evaluator import ColumnEvaluator, EvalDomain, eval_rows_host
from ..polynomial.expression import (
    CompressedGates,
    Expression,
    GroupedPoly,
    QueryIndexContext,
)
from ..utils.tracing import span

NUM_CHALLENGE_BITS = 128


# ---------------------------------------------------------------------------
# Lookup arguments (log-derivative; reference plonk/lookup.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LookupArguments:
    lookup_polys: List[Expression]
    table_polys: List[Expression]
    has_vector_lookup: bool

    def num_lookups(self) -> int:
        return len(self.lookup_polys)

    def vanishing_lookup_polys(self, ctx: QueryIndexContext) -> List[Expression]:
        from ..polynomial.expression import Poly, Query

        lookup_offset = ctx.num_selectors + ctx.num_fixed + ctx.num_advice
        exprs = []
        for i, L in enumerate(self.lookup_polys):
            exprs.append(L - Poly(Query(lookup_offset + i * 5)))
        for i, T in enumerate(self.table_polys):
            exprs.append(T - Poly(Query(lookup_offset + i * 5 + 1)))
        return exprs

    def log_derivative_lhs_and_rhs(self, ctx: QueryIndexContext) -> List[Expression]:
        from ..polynomial.expression import Challenge, Const, Poly, Query

        challenge_index = 1 if self.has_vector_lookup else 0
        lookup_offset = ctx.num_selectors + ctx.num_fixed + ctx.num_advice
        exprs = []
        for i in range(self.num_lookups()):
            r = Challenge(challenge_index)
            l, t, m, h, g = (
                Poly(Query(lookup_offset + i * 5 + j)) for j in range(5)
            )
            exprs.append(h * (l + r) - Const(1))
            exprs.append(g * (t + r) - m)
        return exprs


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlonkStructure:
    curve: CurveParams  # the commitment curve; scalar field hosts the table
    k: int
    num_io: int
    selectors: List[List[bool]]
    fixed_columns: List[List[int]]
    num_advice_columns: int
    num_challenges: int
    round_sizes: List[int]
    compressed_gates: CompressedGates
    gates: List[Expression]
    permutation_matrix: List[Tuple[int, int, int]]  # sparse (row, col, val)
    lookup_arguments: Optional[LookupArguments]
    num_g1_elems: int = 0
    num_g2_elems: int = 0
    target_group_folding_degree: int = 0
    target_group_cross_terms: int = 0

    # -- small helpers ------------------------------------------------------
    @property
    def modulus(self) -> int:
        return self.curve.scalar_modulus

    @property
    def lf(self):
        return limb_field(self.modulus)

    def num_lookups(self) -> int:
        return self.lookup_arguments.num_lookups() if self.lookup_arguments else 0

    def has_vector_lookup(self) -> bool:
        return bool(self.lookup_arguments and self.lookup_arguments.has_vector_lookup)

    def num_fold_vars(self) -> int:
        return self.num_advice_columns + 5 * self.num_lookups()

    def get_degree_for_folding(self) -> int:
        return len(self.compressed_gates.grouped)

    def query_ctx(self) -> QueryIndexContext:
        return QueryIndexContext(
            num_selectors=len(self.selectors),
            num_fixed=len(self.fixed_columns),
            num_advice=self.num_advice_columns,
            num_challenges=self.num_challenges,
            num_lookups=self.num_lookups(),
        )

    # -- evaluators (cached) -------------------------------------------------
    def _evaluator(self, which: str) -> ColumnEvaluator:
        cache = getattr(self, "_eval_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_eval_cache", cache)
        if which not in cache:
            expr = {
                "compressed": self.compressed_gates.compressed,
                "homogeneous": self.compressed_gates.homogeneous,
            }[which]
            cache[which] = ColumnEvaluator(
                expr,
                self.modulus,
                self.num_advice_columns,
                self.num_lookups(),
                self.selectors,
                self.fixed_columns,
                1 << self.k,
            )
        return cache[which]

    def _fold_evaluator(self):
        """Multi-point fold evaluator (polynomial/fold_evaluator.py):
        evaluates P(W1 + j*W2) at every cross-term point j in one jitted
        program — the device route of commit_cross_terms."""
        cache = getattr(self, "_eval_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_eval_cache", cache)
        if "fold" not in cache:
            from ..polynomial.fold_evaluator import FoldEvaluator

            cache["fold"] = FoldEvaluator(
                self.compressed_gates.homogeneous,
                self.modulus,
                self.num_advice_columns,
                self.num_lookups(),
                self.selectors,
                self.fixed_columns,
                1 << self.k,
            )
        return cache["fold"]

    def _native_fold_evaluator(self, which: str = "homogeneous"):
        """Row-parallel native C++ VM (polynomial/native_evaluator) — the
        CPU-host runtime path of commit_cross_terms and the is_sat checks
        (the reference's rayon GraphEvaluator role)."""
        cache = getattr(self, "_eval_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_eval_cache", cache)
        key = f"native_fold:{which}"
        if key not in cache:
            from ..polynomial.native_evaluator import NativeFoldEvaluator

            expr = {
                "compressed": self.compressed_gates.compressed,
                "homogeneous": self.compressed_gates.homogeneous,
            }[which]
            cache[key] = NativeFoldEvaluator(
                expr,
                self.modulus,
                self.num_advice_columns,
                self.num_lookups(),
                self.selectors,
                self.fixed_columns,
                1 << self.k,
            )
        return cache[key]

    def _eval_full(self, which: str, Ws, challenges):
        """Evaluate a compressed-gate expression on every row, on the
        platform's fold_eval route (routes.py): the native row VM (a j=0
        fold against a zero witness), or the prover's multi-point device
        evaluator at the single point j=0 (the homogeneous expression at
        u=1 equals the compressed one, so both `which` modes ride one
        evaluator).  Returns (nrow, 16) Montgomery limbs."""
        p = self.modulus
        if route("fold_eval") == "native":
            nev = self._native_fold_evaluator(which)
            zeros = [np.zeros_like(np.asarray(w)) for w in Ws]
            return nev.fold_eval_multi(
                tuple(Ws), tuple(zeros), [0],
                [c % p for c in challenges],
                [0] * len(challenges),
            )[0]
        ch_h = list(challenges) + ([1] if which == "compressed" else [])
        return self._fold_evaluator().fold_eval_multi(
            tuple(Ws), tuple(Ws), [0], [c % p for c in ch_h],
            [0] * len(ch_h),
        )[0]

    # -- satisfaction checks -------------------------------------------------
    def is_sat(self, ck, ro_nark, U: "PlonkInstance", W: "PlonkWitness"):
        """reference plonk/mod.rs:436-493; raises on failure."""
        with span("sat_sps_verify"):
            sps_verify(U, ro_nark)
        with span("sat_gate_eval"):
            out = self._eval_full("compressed", W.W, U.challenges)
            vals = np.asarray(out)
        nonzero = int(np.sum(np.any(vals != 0, axis=-1)))
        if nonzero:
            raise SatError(f"gate evaluation mismatch on {nonzero}/{1 << self.k} rows")
        with span("sat_log_derivative"):
            if not self.is_sat_log_derivative(W):
                raise SatError("log derivative relation not satisfied")
        for i, (ci, wi) in enumerate(zip(U.W_commitments, W.W)):
            with span(f"sat_W_commit_{i}"):
                if ck.commit_device(wi) != ci:
                    raise SatError(f"W commitment mismatch at round {i}")

    def is_sat_relaxed(self, ck, U: "RelaxedPlonkInstance", W: "RelaxedPlonkWitness"):
        """reference plonk/mod.rs:495-560."""
        with span("sat_gate_eval"):
            out = self._eval_full(
                "homogeneous", W.W, list(U.challenges) + [U.u]
            )
            vals = np.asarray(out)
        evals = np.asarray(W.E)
        nonzero = int(np.sum(np.any(vals != evals, axis=-1)))
        if nonzero:
            raise SatError(
                f"relaxed gate evaluation != E on {nonzero}/{1 << self.k} rows"
            )
        with span("sat_log_derivative"):
            if not self.is_sat_log_derivative(W):
                raise SatError("log derivative relation not satisfied")
        for i, (ci, wi) in enumerate(zip(U.W_commitments, W.W)):
            with span(f"sat_W_commit_{i}"):
                if ck.commit_device(wi) != ci:
                    raise SatError(f"W commitment mismatch at round {i}")
        with span("sat_E_commit"):
            if ck.commit_device(W.E) != U.E_commitment:
                raise SatError("E commitment mismatch")
        ctx = getattr(self, "groth16_ctx", None)
        if ctx is not None:
            with span("sat_gt"):
                ctx.gt_is_sat(U)  # real-pairing Gt decider (beyond the reference)

    def is_sat_perm(self, U: "RelaxedPlonkInstance", W: "RelaxedPlonkWitness"):
        """P*Z = Z with Z = instance || advice part of W[0]
        (reference plonk/mod.rs:563-589)."""
        p = self.modulus
        nrow = 1 << self.k
        # P is a permutation with unit entries (one (i, j, 1) per row, see
        # table/circuit.py permutation_matrix), so P*Z = Z reduces to
        # Z[i] == Z[j] on the non-identity entries — compared directly on
        # the plain limb planes, no python-int decode of the witness
        general = [e for e in self.permutation_matrix if e[2] != 1]
        if not general:
            idx = getattr(self, "_perm_idx", None)
            if idx is None:
                pairs = [
                    (i, j) for (i, j, v) in self.permutation_matrix if i != j
                ]
                idx = (
                    np.asarray([i for i, _ in pairs], dtype=np.int64),
                    np.asarray([j for _, j in pairs], dtype=np.int64),
                )
                object.__setattr__(self, "_perm_idx", idx)
            try:
                from ..fields.native64 import available as _n64_ok
                from ..fields.native64 import from_mont16
            except ImportError:  # pragma: no cover
                _n64_ok = lambda: False
            w_mont = np.asarray(W.W[0])[: nrow * self.num_advice_columns]
            if _n64_ok():
                w_plain = from_mont16(p, w_mont)
            else:
                w_plain = np.asarray(self.lf.to_plain(w_mont))
            from ..fields.limbs import ints_to_limbs

            ZR = np.concatenate(
                [ints_to_limbs([v % p for v in U.instance]), w_plain], axis=0
            )
            i_idx, j_idx = idx
            mismatch = int(np.sum(~np.all(ZR[i_idx] == ZR[j_idx], axis=1)))
        else:  # non-unit entries: dense python fallback
            w0 = self.lf.decode(W.W[0])[: nrow * self.num_advice_columns]
            Z = [v % p for v in U.instance] + w0
            y = [0] * len(Z)
            for (i, j, v) in self.permutation_matrix:
                y[i] = (y[i] + v * Z[j]) % p
            mismatch = sum(1 for a, b in zip(y, Z) if a % p != b % p)
        if mismatch:
            raise SatError(f"permutation check failed on {mismatch} entries")

    def is_sat_log_derivative(self, W) -> bool:
        """sum_i h_i == sum_i g_i per lookup (reference plonk/mod.rs:592-622)."""
        nlookup = self.num_lookups()
        if nlookup == 0:
            return True
        nrow = 1 << self.k
        round_idx = 2 if self.has_vector_lookup() else 1
        vals = self.lf.decode(W.W[round_idx])
        p = self.modulus
        for i in range(nlookup):
            h = vals[(2 * i) * nrow : (2 * i + 1) * nrow]
            g = vals[(2 * i + 1) * nrow : (2 * i + 2) * nrow]
            if (sum(h) - sum(g)) % p != 0:
                return False
        return True

    # -- SPS protocol --------------------------------------------------------
    def dry_run_sps_protocol(self) -> "PlonkTrace":
        return PlonkTrace(
            u=PlonkInstance.new(
                self.curve,
                self.num_io,
                self.num_challenges,
                len(self.round_sizes),
                self.num_g1_elems,
                self.num_g2_elems,
            ),
            w=PlonkWitness.zeros(self.lf, self.round_sizes),
        )

    def run_sps_protocol(
        self, ck, instance: List[int], advice: List[List[int]], ro_nark,
        rng=None, mesh=None,
    ) -> "PlonkTrace":
        """advice: raw advice columns (each 2^k ints), or a PackedWitness
        (witness-tape replay output, table/packed.py).  With a mesh, the
        witness commitments ride the sharded MSM — the multi-chip analog of
        the reference's best_multiexp calls in run_sps_protocol
        (/root/reference/src/plonk/mod.rs:653-907)."""
        from ..table.packed import DeviceWitness, PackedWitness

        rng = rng or random.Random(0x5050)
        n = self.num_challenges
        if isinstance(advice, (PackedWitness, DeviceWitness)) and n >= 2:
            # only the lookup coefficient rounds (SPS-2/3) read int columns;
            # SPS-1 (gate-compression challenge, no lookups) commits the
            # packed/device witness directly
            advice = advice.to_int_cols()
        if n == 0:
            return self._sps_0(ck, instance, advice, rng, mesh=mesh)
        if n == 1:
            return self._sps_1(ck, instance, advice, ro_nark, rng, mesh=mesh)
        if n == 2:
            return self._sps_2(ck, instance, advice, ro_nark, rng, mesh=mesh)
        if n == 3:
            return self._sps_3(ck, instance, advice, ro_nark, rng, mesh=mesh)
        raise ValueError(f"unsupported challenge count {n}")

    def _concat_pad(self, cols: List[List[int]]) -> List[int]:
        nrow = 1 << self.k
        out: List[int] = []
        for c in cols:
            out.extend(c)
            out.extend([0] * (nrow - len(c)))
        return out

    def _random_group_elements(self, rng):
        # real-proof mode: pull actual Groth16 elements [A,C,vk_x]/[B] from
        # the attached context (snark/groth16.py) instead of the reference's
        # random placeholders (plonk/mod.rs:690-703 "TODO(jbeal)")
        ctx = getattr(self, "groth16_ctx", None)
        if ctx is not None:
            return ctx.provide_elements()
        Fb = field(self.curve.base_modulus)
        g1 = [AffinePoint.random(self.curve, rng) for _ in range(self.num_g1_elems)]
        g2 = [G2Point.random(rng, Fb) for _ in range(self.num_g2_elems)]
        return g1, g2

    def _sps_0(self, ck, instance, advice, rng, mesh=None) -> "PlonkTrace":
        from ..table.packed import DeviceWitness, PackedWitness

        lf = self.lf
        with span("witness_encode"):
            if isinstance(advice, (PackedWitness, DeviceWitness)):
                # packed fast path: raw limb planes straight into the
                # Montgomery encode, no python-int round trip; the
                # DeviceWitness variant is one device scatter into a
                # cached Montgomery template (table/packed.py)
                assert advice.nrow == 1 << self.k
                W1 = advice.encode_mont(lf)
            else:
                W1 = lf.encode_padded(advice, 1 << self.k)
        with span("witness_commit"):
            if isinstance(advice, DeviceWitness) and mesh is None:
                # incremental commit: template commitment + an MSM over
                # only the tape's write positions (ops/commitment.py)
                C1 = ck.commit_delta(advice)
            else:
                C1 = ck.commit_device(W1, mesh=mesh)
        with span("sps_group_elements"):
            g1, g2 = self._random_group_elements(rng)
        return PlonkTrace(
            u=PlonkInstance(self.curve, [C1], list(instance), [], g1, g2),
            w=PlonkWitness(lf, [W1]),
        )

    def _sps_1(self, ck, instance, advice, ro_nark, rng, mesh=None) -> "PlonkTrace":
        trace = self._sps_0(ck, instance, advice, rng, mesh=mesh)
        base = field(self.curve.base_modulus)
        scalar = field(self.modulus)
        for inst in instance:
            ro_nark.absorb_field(base(inst % self.curve.base_modulus))
        for c in trace.u.W_commitments:
            ro_nark.absorb_point(c)
        r1 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        trace.u.challenges.append(r1)
        return trace

    def _sps_2(self, ck, instance, advice, ro_nark, rng, mesh=None) -> "PlonkTrace":
        lf = self.lf
        base = field(self.curve.base_modulus)
        scalar = field(self.modulus)
        # round 1: ls/ts/ms with r = 0 (no vector lookup => compression unused)
        # NOTE: columns are laid out interleaved per lookup (l_i,t_i,m_i), the
        # layout the evaluator's index map expects (reference eval.rs:170-204);
        # the reference's SPS builder concatenates [ls..,ts..,ms..] instead
        # (plonk/mod.rs:765-772), which disagrees with its own evaluator for
        # >1 lookups -- we use the consistent interleaved layout.
        ls, ts, ms = self._lookup_coeff_1(advice, 0)
        W1 = lf.encode_padded(
            list(advice) + list(_interleave3(ls, ts, ms)), 1 << self.k
        )
        cm1 = ck.commit_device(W1, mesh=mesh)
        for inst in instance:
            ro_nark.absorb_field(base(inst % self.curve.base_modulus))
        ro_nark.absorb_point(cm1)
        r1 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        # round 2
        hs, gs = self._lookup_coeff_2(ls, ts, ms, r1)
        W2 = lf.encode_padded(_interleave(hs, gs), 1 << self.k)
        cm2 = ck.commit_device(W2, mesh=mesh)
        ro_nark.absorb_point(cm2)
        r2 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        g1, g2 = self._random_group_elements(rng)
        return PlonkTrace(
            u=PlonkInstance(self.curve, [cm1, cm2], list(instance), [r1, r2], g1, g2),
            w=PlonkWitness(lf, [W1, W2]),
        )

    def _sps_3(self, ck, instance, advice, ro_nark, rng, mesh=None) -> "PlonkTrace":
        lf = self.lf
        base = field(self.curve.base_modulus)
        scalar = field(self.modulus)
        for inst in instance:
            ro_nark.absorb_field(base(inst % self.curve.base_modulus))
        # round 1: advice only
        W1 = lf.encode_padded(advice, 1 << self.k)
        cm1 = ck.commit_device(W1, mesh=mesh)
        ro_nark.absorb_point(cm1)
        r1 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        # round 2: l/t/m with vector compression challenge r1 (interleaved, see
        # the layout note in _sps_2)
        ls, ts, ms = self._lookup_coeff_1(advice, r1)
        W2 = lf.encode_padded(_interleave3(ls, ts, ms), 1 << self.k)
        cm2 = ck.commit_device(W2, mesh=mesh)
        ro_nark.absorb_point(cm2)
        r2 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        # round 3: h/g
        hs, gs = self._lookup_coeff_2(ls, ts, ms, r2)
        W3 = lf.encode_padded(_interleave(hs, gs), 1 << self.k)
        cm3 = ck.commit_device(W3, mesh=mesh)
        ro_nark.absorb_point(cm3)
        r3 = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        g1, g2 = self._random_group_elements(rng)
        return PlonkTrace(
            u=PlonkInstance(
                self.curve, [cm1, cm2, cm3], list(instance), [r1, r2, r3], g1, g2
            ),
            w=PlonkWitness(lf, [W1, W2, W3]),
        )

    # -- lookup coefficient evaluation (reference plonk/lookup.rs:211-344) ---
    def _lookup_coeff_1(self, advice, r: int):
        la = self.lookup_arguments
        assert la is not None
        p = self.modulus
        nrow = 1 << self.k
        dom = EvalDomain(
            modulus=p,
            num_advice=self.num_advice_columns,
            num_lookup=self.num_lookups(),
            challenges=[r],
            selectors=self.selectors,
            fixed=self.fixed_columns,
            W1s=[self._concat_pad(advice)],
            W2s=[],
        )
        # LookupEvalDomain indexes advice columns directly, which here is the
        # same as round-0 concatenated layout used by EvalDomain.
        ls = [eval_rows_host(poly, dom) for poly in la.lookup_polys]
        ts = [eval_rows_host(poly, dom) for poly in la.table_polys]
        ms = []
        for l, t in zip(ls, ts):
            counts = {}
            for v in l:
                counts[v] = counts.get(v, 0) + 1
            seen = set()
            m = []
            for tv in t:
                if tv in seen:
                    m.append(0)
                else:
                    seen.add(tv)
                    m.append(counts.get(tv, 0))
            ms.append(m)
        return ls, ts, ms

    def _lookup_coeff_2(self, ls, ts, ms, r: int):
        p = self.modulus
        hs, gs = [], []
        for l, t, m in zip(ls, ts, ms):
            h = [pow((li + r) % p, -1, p) if (li + r) % p != 0 else 0 for li in l]
            g = [
                (mi * (pow((ti + r) % p, -1, p) if (ti + r) % p != 0 else 0)) % p
                for ti, mi in zip(t, m)
            ]
            hs.append(h)
            gs.append(g)
        return hs, gs


def _interleave(hs, gs):
    out = []
    for h, g in zip(hs, gs):
        out.append(h)
        out.append(g)
    return out


def _interleave3(ls, ts, ms):
    out = []
    for l, t, m in zip(ls, ts, ms):
        out.extend([l, t, m])
    return out


class SatError(Exception):
    pass


# ---------------------------------------------------------------------------
# Instances / witnesses
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlonkInstance:
    curve: CurveParams
    W_commitments: List[AffinePoint]
    instance: List[int]
    challenges: List[int]
    g1_elements: List[AffinePoint]
    g2_elements: List[G2Point]

    @classmethod
    def new(cls, curve, num_io, num_challenges, num_witness, num_g1, num_g2):
        return cls(
            curve,
            [AffinePoint.identity(curve) for _ in range(num_witness)],
            [0] * num_io,
            [0] * num_challenges,
            [AffinePoint.identity(curve) for _ in range(num_g1)],
            [G2Point.identity(field(curve.base_modulus)) for _ in range(num_g2)],
        )

    def to_relax(self) -> "RelaxedPlonkInstance":
        Fb = field(self.curve.base_modulus)
        return RelaxedPlonkInstance(
            curve=self.curve,
            W_commitments=list(self.W_commitments),
            E_commitment=AffinePoint.identity(self.curve),
            instance=list(self.instance),
            challenges=list(self.challenges),
            u=1,
            g1_elements=list(self.g1_elements),
            g2_elements=list(self.g2_elements),
            gt_element=Tuple12.one(Fb),
        )

    def absorb_into(self, ro):
        """reference plonk/mod.rs:385-393."""
        base = field(self.curve.base_modulus)
        for c in self.W_commitments:
            ro.absorb_point(c)
        for v in self.instance:
            ro.absorb_field(base(v % self.curve.base_modulus))
        for v in self.challenges:
            ro.absorb_field(base(v % self.curve.base_modulus))
        for g in self.g1_elements:
            ro.absorb_point(g)
        for g in self.g2_elements:
            ro.absorb_g2_point(g)


@dataclasses.dataclass
class RelaxedPlonkInstance:
    curve: CurveParams
    W_commitments: List[AffinePoint]
    E_commitment: AffinePoint
    instance: List[int]
    challenges: List[int]
    u: int
    g1_elements: List[AffinePoint]
    g2_elements: List[G2Point]
    gt_element: Tuple12

    @classmethod
    def new(cls, curve, num_io, num_challenges, num_witness, num_g1, num_g2):
        Fb = field(curve.base_modulus)
        return cls(
            curve,
            [AffinePoint.identity(curve) for _ in range(num_witness)],
            AffinePoint.identity(curve),
            [0] * num_io,
            [0] * num_challenges,
            0,
            [AffinePoint.identity(curve) for _ in range(num_g1)],
            [G2Point.identity(Fb) for _ in range(num_g2)],
            Tuple12.one(Fb),
        )

    def absorb_into(self, ro):
        """reference plonk/mod.rs:395-406."""
        base = field(self.curve.base_modulus)
        for c in self.W_commitments:
            ro.absorb_point(c)
        ro.absorb_point(self.E_commitment)
        for v in self.instance:
            ro.absorb_field(base(v % self.curve.base_modulus))
        for v in self.challenges:
            ro.absorb_field(base(v % self.curve.base_modulus))
        ro.absorb_field(base(self.u % self.curve.base_modulus))
        for g in self.g1_elements:
            ro.absorb_point(g)
        for g in self.g2_elements:
            ro.absorb_g2_point(g)
        ro.absorb_fp12_tuple(self.gt_element)

    def fold(
        self,
        U2: PlonkInstance,
        cross_term_g1_commits: List[AffinePoint],
        cross_term_gt_commits: List[Tuple12],
        r: int,
    ) -> "RelaxedPlonkInstance":
        """reference plonk/mod.rs:979-1081."""
        p = self.curve.scalar_modulus
        W_commitments = [
            w1.add(w2.scalar_mul(r))
            for w1, w2 in zip(self.W_commitments, U2.W_commitments)
        ]
        g1_elements = [
            a.add(b.scalar_mul(r)) for a, b in zip(self.g1_elements, U2.g1_elements)
        ]
        g2_elements = [
            a.add(b.scalar_mul(r)) for a, b in zip(self.g2_elements, U2.g2_elements)
        ]
        instance = [(a + r * b) % p for a, b in zip(self.instance, U2.instance)]
        challenges = [(a + r * b) % p for a, b in zip(self.challenges, U2.challenges)]
        u = (self.u + r) % p

        E_commitment = self.E_commitment
        rpow = r
        for tk in cross_term_g1_commits:
            E_commitment = E_commitment.add(tk.scalar_mul(rpow))
            rpow = (rpow * r) % p

        gt_element = self.gt_element
        rpow = r
        for gt in cross_term_gt_commits:
            gt_element = gt_element.mul(gt.scalar_mul(rpow))
            rpow = (rpow * r) % p

        return RelaxedPlonkInstance(
            self.curve,
            W_commitments,
            E_commitment,
            instance,
            challenges,
            u,
            g1_elements,
            g2_elements,
            gt_element,
        )

    def __eq__(self, o):
        return (
            self.W_commitments == o.W_commitments
            and self.E_commitment == o.E_commitment
            and self.instance == o.instance
            and self.challenges == o.challenges
            and self.u == o.u
            and self.g1_elements == o.g1_elements
            and self.g2_elements == o.g2_elements
            and self.gt_element == o.gt_element
        )


class PlonkWitness:
    """Witness rounds as device Montgomery limb arrays."""

    def __init__(self, lf, W):
        self.lf = lf
        self.W = list(W)

    @classmethod
    def zeros(cls, lf, round_sizes):
        return cls(lf, [lf.zero((sz,)) for sz in round_sizes])

    def to_relax(self, k: int) -> "RelaxedPlonkWitness":
        return RelaxedPlonkWitness(self.lf, list(self.W), self.lf.zero((1 << k,)))

    def to_ints(self) -> List[List[int]]:
        return [self.lf.decode(w) for w in self.W]


@lru_cache(maxsize=None)
def _witness_fold_jit(p: int, n_rounds: int, n_terms: int):
    import jax

    lf = limb_field(p)

    def run(W1, W2, E, Ts, r_m, rp):
        W = tuple(lf.add(a, lf.mul(r_m, b)) for a, b in zip(W1, W2))
        for k, t in enumerate(Ts):
            E = lf.add(E, lf.mul(rp[k][None], t))
        return W, E

    return jax.jit(run)


class RelaxedPlonkWitness:
    def __init__(self, lf, W, E):
        self.lf = lf
        self.W = list(W)
        self.E = E

    @classmethod
    def zeros(cls, lf, k, round_sizes):
        return cls(lf, [lf.zero((sz,)) for sz in round_sizes], lf.zero((1 << k,)))

    def fold(self, W2: PlonkWitness, cross_terms: List, r: int,
             mesh=None) -> "RelaxedPlonkWitness":
        """W' = W1 + r*W2; E' = E + sum_k r^k T_k (reference plonk/mod.rs:1097),
        as ONE fused program per shape instead of ~16 separate RLC passes.
        On the native encode route (CPU) the RLC runs on the native 4x64
        Montgomery kernel.

        With a mesh, operands are row-sharded and GSPMD partitions the
        (purely elementwise) RLC across the devices — the multi-chip analog
        of the reference's rayon par_iter at plonk/mod.rs:1104,1122."""
        lf = self.lf
        p = lf.modulus
        rpows = []
        rpow = r % p
        for _ in cross_terms:
            rpows.append(rpow)
            rpow = (rpow * r) % p

        import jax

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            from ..parallel.mesh import AXIS

            ndev = mesh.devices.size
            sh = NamedSharding(mesh, PartitionSpec(AXIS))

            def put(a):
                return jax.device_put(a, sh) if a.shape[0] % ndev == 0 else a

            W1s = tuple(put(a) for a in self.W)
            W2s = tuple(put(a) for a in W2.W)
            E1 = put(self.E)
            cts = tuple(put(t) for t in cross_terms)
            r_m = lf.const(r % p, (1,))
            rp = lf.encode(rpows) if rpows else lf.zero((0,))
            W_out, E = _witness_fold_jit(p, len(self.W), len(cross_terms))(
                W1s, W2s, E1, cts, r_m, rp
            )
            return RelaxedPlonkWitness(lf, list(W_out), E)

        if route("encode") == "native":
            try:
                from ..fields.native64 import (
                    available,
                    limbs16_to_64,
                    limbs64_to_16,
                    rlc_mont,
                )

                if available():
                    import jax.numpy as jnp
                    import numpy as np

                    def nat_rlc(a, b, rr):
                        return jnp.asarray(limbs64_to_16(rlc_mont(
                            p,
                            limbs16_to_64(np.asarray(a)),
                            limbs16_to_64(np.asarray(b)),
                            rr,
                        )))

                    W_out = [
                        nat_rlc(a, b, r % p)
                        for a, b in zip(self.W, W2.W)
                    ]
                    E = self.E
                    for k, t in enumerate(cross_terms):
                        E = nat_rlc(E, t, rpows[k])
                    return RelaxedPlonkWitness(lf, W_out, E)
            except ImportError:  # pragma: no cover
                pass

        r_m = lf.const(r % p, (1,))
        rp = lf.encode(rpows) if rpows else lf.zero((0,))
        W_out, E = _witness_fold_jit(p, len(self.W), len(cross_terms))(
            tuple(self.W), tuple(W2.W), self.E, tuple(cross_terms), r_m, rp
        )
        return RelaxedPlonkWitness(lf, list(W_out), E)


@dataclasses.dataclass
class PlonkTrace:
    u: PlonkInstance
    w: PlonkWitness

    def to_relax(self, k: int) -> "RelaxedPlonkTrace":
        return RelaxedPlonkTrace(self.u.to_relax(), self.w.to_relax(k))


@dataclasses.dataclass
class RelaxedPlonkTrace:
    U: RelaxedPlonkInstance
    W: RelaxedPlonkWitness


# ---------------------------------------------------------------------------
# SPS verification (reference src/sps.rs)
# ---------------------------------------------------------------------------


class SpsError(Exception):
    pass


def sps_verify(U: PlonkInstance, ro_nark):
    num_challenges = len(U.challenges)
    if num_challenges == 0:
        return
    base = field(U.curve.base_modulus)
    scalar = field(U.curve.scalar_modulus)
    for v in U.instance:
        ro_nark.absorb_field(base(v % U.curve.base_modulus))
    for i in range(num_challenges):
        ro_nark.absorb_point(U.W_commitments[i])
        got = ro_nark.squeeze(scalar, NUM_CHALLENGE_BITS).v
        if got != U.challenges[i]:
            raise SpsError(f"challenge mismatch at index {i}")
