"""VanillaFS: the Sangria/Mira non-interactive folding scheme.

Protocol semantics mirror /root/reference/src/nifs/vanilla/mod.rs (challenge
absorb order generate_challenge:144-159, fold orchestration prove:220-251,
verifier:270-292).

Divergence (cross terms): the reference symbolically expands the
homogeneous polynomial into degree slices (GroupedPoly) and interprets each
slice per row (vanilla/mod.rs:101-120).  We instead evaluate the *compact*
homogeneous polynomial at d+1 fold points r = 0..d on RLC-folded
witnesses/challenges and interpolate the slice values with a precomputed
inverse-Vandermonde — exact over the field, ~an order of magnitude less work,
and the compiled graph stays small.  On satisfied traces (the IVC steady
state) two of those evaluations come for free — Q(0) equals the stored error
vector E (is_sat_relaxed invariant) and the leading coefficient vanishes
(is_sat invariant) — so only the d-1 interior points are evaluated
(`assume_sat=True`).  tests/test_nifs.py cross-checks this numeric path
against the symbolic GroupedPoly slices on small circuits.

Gt cross terms: the reference emits *random* placeholder Tuple12s
("TODO(jbeal): Generate the correct target group cross terms",
vanilla/mod.rs:130-134); we reproduce the structure with an injectable RNG.
"""

from __future__ import annotations

import dataclasses
import os
import random
from functools import lru_cache
from typing import List, Tuple

from ..curves.host import AffinePoint, Tuple12
from ..fields.host import field
from ..fields.limbs import limb_field
from ..plonk.structure import (
    NUM_CHALLENGE_BITS,
    PlonkInstance,
    PlonkStructure,
    PlonkTrace,
    PlonkWitness,
    RelaxedPlonkInstance,
    RelaxedPlonkTrace,
    RelaxedPlonkWitness,
    sps_verify,
)
from ..routes import route
from ..utils.tracing import instrument, span


@lru_cache(maxsize=None)
def _inv_vandermonde(p: int, d: int) -> Tuple[Tuple[int, ...], ...]:
    """Inverse of V[j][k] = j^k (mod p), (d+1)x(d+1)."""
    n = d + 1
    V = [[pow(j, k, p) for k in range(n)] for j in range(n)]
    # gaussian inverse mod p
    aug = [row[:] + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(V)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [(x * inv) % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] % p != 0:
                f = aug[r][col]
                aug[r] = [(x - f * y) % p for x, y in zip(aug[r], aug[col])]
    return tuple(tuple(row[n:]) for row in aug)


@lru_cache(maxsize=None)
def _inv_vandermonde_inner(p: int, d: int) -> Tuple[Tuple[int, ...], ...]:
    """Inverse of M[i][j] = (i+1)^(j+1) mod p, (d-1)x(d-1) — the interior
    Vandermonde system once the j=0 row (T_0 = E) and the degree-d column
    (T_d = 0) are eliminated by the satisfaction invariants."""
    n = d - 1
    M = [[pow(i + 1, j + 1, p) for j in range(n)] for i in range(n)]
    aug = [row[:] + [1 if i == j else 0 for j in range(n)]
           for i, row in enumerate(M)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [(x * inv) % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] % p != 0:
                f = aug[r][col]
                aug[r] = [(x - f * y) % p for x, y in zip(aug[r], aug[col])]
    return tuple(tuple(row[n:]) for row in aug)


@lru_cache(maxsize=None)
def _combine_slices_sat_jit(p: int, d: int):
    """Interior combination T_k = sum_j invM[k][j] * (Q_j - E), k = 1..d-1,
    plus an explicit zero T_d.  Valid when both traces satisfy their
    relations: Q(0) = P(W1,ch1,u1) = E row-wise (is_sat_relaxed invariant)
    and the leading coefficient P(W2,ch2,1) = 0 (is_sat invariant) — two of
    the d+1 full-table evaluations come for free."""
    import jax
    import jax.numpy as jnp

    lf = limb_field(p)
    invM = _inv_vandermonde_inner(p, d)

    def run(evals, E):
        diffs = [lf.sub(e, E) for e in evals]
        outs = []
        for k in range(d - 1):
            acc = None
            for j in range(d - 1):
                c = invM[k][j]
                if not c:
                    continue
                t = lf.mul(lf.const(c, (1,)), diffs[j])
                acc = t if acc is None else lf.add(acc, t)
            outs.append(acc if acc is not None else jnp.zeros_like(E))
        outs.append(jnp.zeros_like(E))  # T_d = 0 on satisfied traces
        return tuple(outs)

    return jax.jit(run)


@lru_cache(maxsize=None)
def _combine_slices_jit(p: int, d: int):
    """One fused program for the inverse-Vandermonde combination
    T_k = sum_j invV[k][j] * Q_j (eagerly this was d*(d+1) separate
    full-column CIOS passes)."""
    import jax

    lf = limb_field(p)
    invV = _inv_vandermonde(p, d)

    def run(evals):
        outs = []
        for k in range(1, d + 1):
            acc = None
            for j in range(d + 1):
                c = invV[k][j]
                if not c:
                    continue
                t = lf.mul(lf.const(c, (1,)), evals[j])
                acc = t if acc is None else lf.add(acc, t)
            if acc is None:
                acc = jnp_zeros_like(evals[0])
            outs.append(acc)
        return tuple(outs)

    def jnp_zeros_like(x):
        import jax.numpy as jnp

        return jnp.zeros_like(x)

    return jax.jit(run)


def _debug_check_assume_sat(S: PlonkStructure, W1, W2, ch1, ch2):
    """MIRA_DEBUG_SAT guard for the `assume_sat` cross-term shortcut.

    The shortcut trusts two invariants without checking them: Q(0) equals
    the accumulator's stored error vector E (is_sat_relaxed invariant) and
    the leading coefficient of Q — the homogeneous polynomial evaluated on
    the fresh trace alone — vanishes (is_sat invariant).  Folding a trace
    that violates either silently produces wrong cross terms, detectable
    only by a later strict verify; with MIRA_DEBUG_SAT=1 this re-evaluates
    both rows (2 extra evaluator passes) and fails loudly at prove time.
    """
    import jax.numpy as jnp

    p = S.modulus
    lf = S.lf
    ev = S._evaluator("homogeneous")
    j0 = lf.const(0, (1,))

    def _eval_on(Wc, ch):
        enc = lf.encode([c % p for c in ch]) if ch else lf.zero((0,))
        return ev.fold_eval(Wc, Wc, j0, enc)

    q0 = _eval_on(W1.W, ch1)
    bad = int(jnp.count_nonzero(~lf.is_zero(lf.sub(q0, W1.E))))
    if bad:
        raise ValueError(
            "MIRA_DEBUG_SAT: assume_sat contract violated — the accumulator "
            f"does not satisfy its relaxed relation (Q(0) != E on {bad} rows). "
            "Pass assume_sat=False to commit_cross_terms, or fix the trace."
        )
    lead = _eval_on(W2.W, ch2)
    bad = int(jnp.count_nonzero(~lf.is_zero(lead)))
    if bad:
        raise ValueError(
            "MIRA_DEBUG_SAT: assume_sat contract violated — the incoming "
            f"trace does not satisfy its relation (leading coefficient "
            f"nonzero on {bad} rows). Pass assume_sat=False to "
            "commit_cross_terms, or fix the trace."
        )


@dataclasses.dataclass
class VanillaFSProverParam:
    S: PlonkStructure
    pp_digest: AffinePoint


class VanillaFS:
    """Stateless folding operations (reference nifs/vanilla/mod.rs:57-293)."""

    # -- cross terms ---------------------------------------------------------
    @staticmethod
    @instrument
    def commit_cross_terms(
        ck,
        S: PlonkStructure,
        U1: RelaxedPlonkInstance,
        W1: RelaxedPlonkWitness,
        U2: PlonkInstance,
        W2: PlonkWitness,
        rng=None,
        assume_sat: bool = True,
        mesh=None,
    ):
        rng = rng or random.Random(0xC405)
        p = S.modulus
        d = S.get_degree_for_folding() - 1  # max degree of the homogeneous poly

        ch1 = list(U1.challenges) + [U1.u]
        ch2 = list(U2.challenges) + [1]  # fresh instance folds with u = 1

        if assume_sat and d >= 1 and os.environ.get("MIRA_DEBUG_SAT"):
            _debug_check_assume_sat(S, W1, W2, ch1, ch2)

        if assume_sat and d >= 1:
            # Q(0) = E and leading coeff = 0 by the two satisfaction
            # invariants: only the d-1 interior evaluations are computed.
            js = list(range(1, d))
        else:
            js = list(range(d + 1))

        import jax

        W1_W, W2_W, W1_E = W1.W, W2.W, W1.E
        if mesh is not None:
            # Multi-chip: shard the row-parallel evaluation data across the
            # mesh and let GSPMD insert the collectives (rotations become
            # collective-permutes); commits ride the sharded MSM.  This
            # distributes the reference's rayon row loop
            # (/root/reference/src/nifs/vanilla/mod.rs:109-120) over chips.
            from jax.sharding import NamedSharding, PartitionSpec

            from ..parallel.mesh import AXIS

            ndev = mesh.devices.size
            sh = NamedSharding(mesh, PartitionSpec(AXIS))

            def put(a):
                return (
                    jax.device_put(a, sh) if a.shape[0] % ndev == 0 else a
                )

            W1_W = [put(w) for w in W1_W]
            W2_W = [put(w) for w in W2_W]
            W1_E = put(W1_E)
        # over a mesh the device evaluator, which GSPMD partitions by rows
        # (the row VM would gather the shards to the host)
        impl = "jnp" if mesh is not None else route("fold_eval")
        if impl == "native" and js:
            # native row-VM eval + native inverse-Vandermonde combine,
            # entirely in 4x64 limbs (one 16-limb conversion at the end)
            import jax.numpy as jnp
            import numpy as np

            from ..fields.native64 import (
                limbs16_to_64,
                limbs64_to_16,
                lincomb_mont,
            )

            nev = S._native_fold_evaluator()
            with span("cross_term_eval"):
                outs64 = nev.fold_eval_multi(W1_W, W2_W, js, ch1, ch2, as64=True)
            nrow = outs64.shape[1]
            if assume_sat and d >= 1:
                # T_k = sum_j invM[k][j]*(Q_j - E) == lincomb over
                # [Q_1..Q_{d-1}, E] with the E coefficient folded in
                invM = _inv_vandermonde_inner(p, d)
                E64 = limbs16_to_64(np.asarray(W1_E))
                ins = np.concatenate([outs64, E64[None]], axis=0)
                coefs = [
                    list(invM[k]) + [(-sum(invM[k])) % p]
                    for k in range(d - 1)
                ]
                T64 = lincomb_mont(p, ins, coefs)
                cross_terms = [
                    jnp.asarray(limbs64_to_16(T64[k])) for k in range(d - 1)
                ]
                cross_terms.append(
                    jnp.zeros((nrow, 16), jnp.uint32)  # T_d = 0 when sat
                )
            else:
                invV = _inv_vandermonde(p, d)
                coefs = [list(invV[k]) for k in range(1, d + 1)]
                T64 = lincomb_mont(p, outs64, coefs)
                cross_terms = [
                    jnp.asarray(limbs64_to_16(T64[k])) for k in range(d)
                ]
        else:
            evals = []
            if js:
                with span("cross_term_eval"):
                    outs = S._fold_evaluator().fold_eval_multi(
                        W1_W, W2_W, js, ch1, ch2, mesh=mesh
                    )
                evals = [outs[i] for i in range(len(js))]
            if assume_sat and d >= 1:
                cross_terms = list(
                    _combine_slices_sat_jit(p, d)(tuple(evals), W1_E)
                )
            else:
                cross_terms = list(_combine_slices_jit(p, d)(tuple(evals)))

        with span("cross_term_commit"):
            commit_many = getattr(ck, "commit_device_many", None)
            skip_last = assume_sat and d >= 1
            # T_d = 0 on satisfied traces (leading-coefficient invariant)
            # — its commitment is the identity, no MSM
            terms = cross_terms[:-1] if skip_last else cross_terms
            if commit_many is not None:
                # two-phase: dispatch the MSMs now, decode AFTER the host
                # has produced the Gt cross terms below — the pairings run
                # while the device works
                decode = commit_many(terms, mesh=mesh, defer=True)
            else:
                pts = [ck.commit_device(t, mesh=mesh) for t in terms]
                decode = lambda: pts  # noqa: E731
        ctx = getattr(S, "groth16_ctx", None)
        if ctx is not None:
            # real bilinear pairing cross terms (snark/groth16.py) — the
            # reference emits random Tuple12s here (vanilla/mod.rs:130-134)
            with span("gt_cross_terms"):
                gt_commits = ctx.gt_cross_terms(U1, U2)
        else:
            Fb = field(S.curve.base_modulus)
            gt_commits = [
                Tuple12.generator(Fb).scalar_mul(rng.randrange(p))
                for _ in range(S.target_group_cross_terms)
            ]
        with span("cross_term_commit"):
            g1_commits = decode()
            if skip_last:
                g1_commits = list(g1_commits)
                g1_commits.append(AffinePoint.identity(S.curve))
        return cross_terms, (g1_commits, gt_commits)

    # -- challenge -----------------------------------------------------------
    @staticmethod
    def generate_challenge(
        pp_digest: AffinePoint,
        ro_acc,
        U1: RelaxedPlonkInstance,
        U2: PlonkInstance,
        cross_term_g1_commits: List[AffinePoint],
        cross_term_gt_commits: List[Tuple12],
    ) -> int:
        scalar = field(U1.curve.scalar_modulus)
        ro_acc.absorb_point(pp_digest)
        U1.absorb_into(ro_acc)
        U2.absorb_into(ro_acc)
        for c in cross_term_g1_commits:
            ro_acc.absorb_point(c)
        for t in cross_term_gt_commits:
            ro_acc.absorb_fp12_tuple(t)
        return ro_acc.squeeze(scalar, NUM_CHALLENGE_BITS).v

    # -- FoldingScheme API ---------------------------------------------------
    @staticmethod
    def setup_params(pp_digest: AffinePoint, S: PlonkStructure):
        return VanillaFSProverParam(S, pp_digest), pp_digest

    @staticmethod
    @instrument
    def generate_plonk_trace(
        ck, instance, witness, pp: VanillaFSProverParam, ro_nark, rng=None,
        mesh=None,
    ) -> PlonkTrace:
        return pp.S.run_sps_protocol(
            ck, instance, witness, ro_nark, rng=rng, mesh=mesh
        )

    @staticmethod
    @instrument
    def prove(
        ck,
        pp: VanillaFSProverParam,
        ro_acc,
        accumulator: RelaxedPlonkTrace,
        incoming: PlonkTrace,
        rng=None,
        mesh=None,
    ):
        """Fold `incoming` into `accumulator` (reference vanilla/mod.rs:220-251).

        Contract: `accumulator` must satisfy its relaxed relation and
        `incoming` its plain relation — cross terms are computed with the
        `assume_sat=True` shortcut (Q(0)=E and a vanishing leading
        coefficient are trusted, not checked).  Violations yield wrong cross
        terms that only a later strict verify catches; set MIRA_DEBUG_SAT=1
        to check the invariants loudly at prove time.
        """
        U1, W1 = accumulator.U, accumulator.W
        U2, W2 = incoming.u, incoming.w

        cross_terms, (g1_commits, gt_commits) = VanillaFS.commit_cross_terms(
            ck, pp.S, U1, W1, U2, W2, rng=rng, mesh=mesh
        )
        r = VanillaFS.generate_challenge(
            pp.pp_digest, ro_acc, U1, U2, g1_commits, gt_commits
        )
        U = U1.fold(U2, g1_commits, gt_commits, r)
        W = W1.fold(W2, cross_terms, r, mesh=mesh)
        return RelaxedPlonkTrace(U, W), (g1_commits, gt_commits)

    @staticmethod
    def verify(
        vp: AffinePoint,
        ro_nark,
        ro_acc,
        U1: RelaxedPlonkInstance,
        U2: PlonkInstance,
        cross_term_commits,
    ) -> RelaxedPlonkInstance:
        g1_commits, gt_commits = cross_term_commits
        sps_verify(U2, ro_nark)
        r = VanillaFS.generate_challenge(vp, ro_acc, U1, U2, g1_commits, gt_commits)
        return U1.fold(U2, g1_commits, gt_commits, r)
