"""End-to-end protocol tests: circuit -> structure -> SPS -> fold -> verify.

Plays the role of the reference's nifs/vanilla/tests.rs + nifs/tests.rs
fixtures (prepare traces, fold, cross-check prove vs verify, then is_sat*
of the folded trace).
"""

import random

import pytest

from mira_tpu.curves.host import BN254_G1, AffinePoint
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu.nifs.vanilla import VanillaFS
from mira_tpu.ops.commitment import CommitmentKey
from mira_tpu.ops.poseidon import create_ro
from mira_tpu.plonk.structure import SatError, SpsError
from mira_tpu.routes import forced
from mira_tpu.polynomial.evaluator import EvalDomain, eval_rows_host
from mira_tpu.table.runner import CircuitRunner

K = 4  # 16 rows


class MulCircuit:
    """Single custom gate: q * (a*b - c) = 0 with a copy constraint a[1]=c[0].
    Exercises SPS-0 (no challenges)."""

    def __init__(self, seed=0):
        self.seed = seed

    @staticmethod
    def configure(cs):
        q = cs.fixed_column()
        a, b, c = (cs.advice_column() for _ in range(3))
        for col in (a, b, c):
            cs.enable_equality(col)
        qe, ae, be, ce = (cs.query(x) for x in (q, a, b, c))
        cs.create_gate("mul", [qe * (ae * be - ce)])
        return (q, a, b, c)

    def synthesize(self, config, ctx):
        q, a, b, c = config
        rng = random.Random(self.seed)
        t = ctx.table
        p = t.modulus
        # row 0
        a0, b0 = rng.randrange(p), rng.randrange(p)
        t.assign_fixed(q, 0, 1)
        t.assign_advice(a, 0, a0)
        t.assign_advice(b, 0, b0)
        c0 = t.assign_advice(c, 0, a0 * b0 % p)
        # row 1: a[1] copies c[0]
        b1 = rng.randrange(p)
        t.assign_fixed(q, 1, 1)
        a1 = t.assign_advice(a, 1, c0.value)
        t.assign_advice(b, 1, b1)
        t.assign_advice(c, 1, c0.value * b1 % p)
        t.copy(c0.cell, a1.cell)
        for row in range(2, 8):
            av, bv = rng.randrange(p), rng.randrange(p)
            t.assign_fixed(q, row, 1)
            t.assign_advice(a, row, av)
            t.assign_advice(b, row, bv)
            t.assign_advice(c, row, av * bv % p)


class TwoGateCircuit:
    """Two custom gates -> compressed with a challenge, SPS-1."""

    def __init__(self, seed=0):
        self.seed = seed

    @staticmethod
    def configure(cs):
        q1 = cs.fixed_column()
        q2 = cs.fixed_column()
        a, b, c = (cs.advice_column() for _ in range(3))
        q1e, q2e, ae, be, ce = (cs.query(x) for x in (q1, q2, a, b, c))
        cs.create_gate("mul", [q1e * (ae * be - ce)])
        cs.create_gate("add", [q2e * (ae + be - ce)])
        return (q1, q2, a, b, c)

    def synthesize(self, config, ctx):
        q1, q2, a, b, c = config
        rng = random.Random(self.seed)
        t = ctx.table
        p = t.modulus
        for row in range(12):
            av, bv = rng.randrange(p), rng.randrange(p)
            t.assign_advice(a, row, av)
            t.assign_advice(b, row, bv)
            if row % 2 == 0:
                t.assign_fixed(q1, row, 1)
                t.assign_advice(c, row, av * bv % p)
            else:
                t.assign_fixed(q2, row, 1)
                t.assign_advice(c, row, (av + bv) % p)


class FiboCircuit:
    """Fibonacci chain with NEXT-rotation queries: q * (a + a.next - b) = 0
    and b[i] copied to a[i+1] (the reference's `fibo_circuit` fixture,
    nifs/tests.rs:92+) -- exercises non-zero rotations through SPS + fold."""

    def __init__(self, seed=0):
        self.seed = seed

    @staticmethod
    def configure(cs):
        q = cs.fixed_column()
        a = cs.advice_column()
        b = cs.advice_column()
        cs.enable_equality(a)
        cs.enable_equality(b)
        qe = cs.query(q)
        ae = cs.query(a)
        an = cs.query(a, 1)  # Rotation::next()
        be = cs.query(b)
        cs.create_gate("fibo", [qe * (ae + an - be)])
        return (q, a, b)

    def synthesize(self, config, ctx):
        q, a, b = config
        t = ctx.table
        p = t.modulus
        rng = random.Random(self.seed)
        f0, f1 = rng.randrange(p), rng.randrange(p)
        pending = []  # b[i] == a[i+2]: copy two rows later
        for row in range(10):
            t.assign_fixed(q, row, 1)
            ac = t.assign_advice(a, row, f0)
            bc = t.assign_advice(b, row, (f0 + f1) % p)
            if len(pending) == 2:
                t.copy(pending.pop(0).cell, ac.cell)
            pending.append(bc)
            f0, f1 = f1, (f0 + f1) % p
        # next rotation of the final gate row reads row 10's a: assign it
        t.assign_advice(a, 10, f0)


def setup(circuit_cls, seed=0):
    runner = CircuitRunner(K, circuit_cls(seed), [], BN254_G1)
    S = runner.collect_structure()
    advice = runner.collect_witness()
    ck = CommitmentKey.setup(BN254_G1, K + 2, b"test")
    return S, advice, ck


def ro():
    return create_ro(BN254_FQ)


@pytest.mark.parametrize("circuit_cls", [MulCircuit, TwoGateCircuit, FiboCircuit])
def test_sps_and_is_sat(circuit_cls):
    S, advice, ck = setup(circuit_cls)
    trace = S.run_sps_protocol(ck, [], advice, ro())
    S.is_sat(ck, ro(), trace.u, trace.w)  # raises on failure

    # tampered witness must fail
    bad = [list(col) for col in advice]
    bad[-1][0] = (bad[-1][0] + 1) % S.modulus
    bad_trace = S.run_sps_protocol(ck, [], bad, ro())
    with pytest.raises(SatError):
        S.is_sat(ck, ro(), bad_trace.u, bad_trace.w)


@pytest.mark.parametrize("circuit_cls", [MulCircuit, TwoGateCircuit, FiboCircuit])
def test_fold_two_steps(circuit_cls):
    S, advice1, ck = setup(circuit_cls, seed=1)
    runner2 = CircuitRunner(K, circuit_cls(2), [], BN254_G1)
    advice2 = runner2.collect_witness()

    pp, vp = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)

    trace1 = VanillaFS.generate_plonk_trace(ck, [], advice1, pp, ro())
    trace2 = VanillaFS.generate_plonk_trace(ck, [], advice2, pp, ro())

    from mira_tpu.plonk.structure import RelaxedPlonkTrace

    acc = trace1.to_relax(S.k)  # wait: start from zero accumulator instead
    # zero accumulator
    from mira_tpu.plonk.structure import (
        RelaxedPlonkInstance,
        RelaxedPlonkWitness,
    )

    acc = RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(
            S.curve, S.num_io, S.num_challenges, len(S.round_sizes),
            S.num_g1_elems, S.num_g2_elems,
        ),
        RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes),
    )
    S.is_sat_relaxed(ck, acc.U, acc.W)  # zero accumulator satisfies

    rng = random.Random(7)
    acc1, proof1 = VanillaFS.prove(ck, pp, ro(), acc, trace1, rng=rng)
    S.is_sat_relaxed(ck, acc1.U, acc1.W)

    # off-circuit verifier reproduces the folded instance
    U_v = VanillaFS.verify(vp, ro(), ro(), acc.U, trace1.u, proof1)
    assert U_v == acc1.U

    acc2, proof2 = VanillaFS.prove(ck, pp, ro(), acc1, trace2, rng=rng)
    S.is_sat_relaxed(ck, acc2.U, acc2.W)
    S.is_sat_perm(acc2.U, acc2.W)

    U_v2 = VanillaFS.verify(vp, ro(), ro(), acc1.U, trace2.u, proof2)
    assert U_v2 == acc2.U


@pytest.mark.parametrize("fold_impl", ["mesh", "jnp", "native"])
@pytest.mark.parametrize("assume_sat", [True, False])
def test_cross_terms_numeric_vs_symbolic(assume_sat, fold_impl):
    """The numeric (evaluate+interpolate) cross terms must equal the
    symbolic GroupedPoly slice evaluation (the reference's algorithm) —
    both via the full d+1-point interpolation and via the satisfied-trace
    shortcut (Q(0) = E, leading coefficient = 0).

    fold_impl="jnp" routes through FoldEvaluator (the device loop over the
    op list, polynomial/fold_evaluator.py); "native" through the C++ row VM
    (polynomial/native_evaluator.py); "mesh" through FoldEvaluator with the
    rows sharded over an 8-device mesh, whatever the platform's route."""
    from mira_tpu.parallel.mesh import make_mesh

    if fold_impl == "native":
        from mira_tpu.polynomial.native_evaluator import available

        if not available():
            pytest.skip("no native toolchain")
    S, advice1, ck = setup(TwoGateCircuit, seed=3)
    runner2 = CircuitRunner(K, TwoGateCircuit(4), [], BN254_G1)
    advice2 = runner2.collect_witness()

    pp, _ = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)
    trace1 = VanillaFS.generate_plonk_trace(ck, [], advice1, pp, ro())
    trace2 = VanillaFS.generate_plonk_trace(ck, [], advice2, pp, ro())
    acc = trace1.to_relax(S.k)

    mesh = make_mesh(8) if fold_impl == "mesh" else None
    with forced("fold_eval", "native" if mesh else fold_impl):
        cross_terms, _ = VanillaFS.commit_cross_terms(
            ck, S, acc.U, acc.W, trace2.u, trace2.w, assume_sat=assume_sat,
            mesh=mesh,
        )

    # symbolic: evaluate each grouped slice per row on host
    dom = EvalDomain(
        modulus=S.modulus,
        num_advice=S.num_advice_columns,
        num_lookup=S.num_lookups(),
        challenges=list(acc.U.challenges) + [acc.U.u]
        + list(trace2.u.challenges) + [1],
        selectors=S.selectors,
        fixed=S.fixed_columns,
        W1s=[S.lf.decode(w) for w in acc.W.W],
        W2s=[S.lf.decode(w) for w in trace2.w.W],
    )
    slices = S.compressed_gates.grouped.iter_from_first()
    assert len(slices) == len(cross_terms)
    for k, (expr, numeric) in enumerate(zip(slices, cross_terms), start=1):
        want = (
            eval_rows_host(expr, dom)
            if expr is not None
            else [0] * (1 << S.k)
        )
        got = S.lf.decode(numeric)
        assert got == want, f"cross term {k} mismatch"


def test_is_sat_perm_detects_broken_copy():
    """Negative case for the vectorized permutation check: corrupting one
    side of a copy constraint must raise (structure.py is_sat_perm)."""
    import numpy as np

    from mira_tpu.table.circuit import RegionCtx, TableData

    class CopyCircuit:
        """a * b = c with c copy-constrained into another advice cell."""

        def configure(self, cs):
            a, b, c = (cs.advice_column() for _ in range(3))
            cs.enable_equality(c)
            cs.create_gate("mul", [cs.query(a) * cs.query(b) - cs.query(c)])
            return (a, b, c)

        def synthesize(self, config, ctx: RegionCtx):
            a, b, c = config
            va = ctx.table.assign_advice(a, 0, 3)
            vb = ctx.table.assign_advice(b, 0, 5)
            vc = ctx.table.assign_advice(c, 0, 15)
            vc2 = ctx.table.assign_advice(c, 1, 15)
            ctx.table.copy(vc.cell, vc2.cell)

    runner = CircuitRunner(K, CopyCircuit(), [], BN254_G1)
    S = runner.collect_structure()
    advice = runner.collect_witness()
    ck = CommitmentKey.setup(BN254_G1, K + 2, b"permtest")
    trace = S.run_sps_protocol(ck, [], advice, ro())
    rel = trace.to_relax(S.k)
    S.is_sat_perm(rel.U, rel.W)  # honest witness passes

    # pick a non-identity permutation entry inside the advice region
    num_io = S.num_io
    entry = next(
        (i, j)
        for (i, j, v) in S.permutation_matrix
        if i != j and i >= num_io and j >= num_io
    )
    flat = entry[0] - num_io
    W0 = np.asarray(rel.W.W[0]).copy()
    orig = S.lf.decode(W0[flat : flat + 1])[0]
    W0[flat] = np.asarray(S.lf.encode([(orig + 1) % S.modulus]))[0]

    import jax.numpy as jnp

    rel.W.W[0] = jnp.asarray(W0)
    with pytest.raises(SatError):
        S.is_sat_perm(rel.U, rel.W)


def test_debug_sat_guard(monkeypatch):
    """MIRA_DEBUG_SAT=1 makes VanillaFS.prove fail loudly when the incoming
    trace violates the assume_sat contract (Q(0)=E / vanishing leading
    coefficient, nifs/vanilla.py `_debug_check_assume_sat`)."""
    S, advice, ck = setup(MulCircuit, seed=3)
    pp, _vp = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)

    from mira_tpu.plonk.structure import (
        RelaxedPlonkInstance,
        RelaxedPlonkTrace,
        RelaxedPlonkWitness,
    )

    acc = RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(
            S.curve, S.num_io, S.num_challenges, len(S.round_sizes),
            S.num_g1_elems, S.num_g2_elems,
        ),
        RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes),
    )

    # tamper the witness BEFORE trace generation: SPS commits happily but the
    # trace no longer satisfies its gate relation
    bad = [list(col) for col in advice]
    bad[-1][0] = (bad[-1][0] + 1) % S.modulus
    bad_trace = VanillaFS.generate_plonk_trace(ck, [], bad, pp, ro())

    monkeypatch.setenv("MIRA_DEBUG_SAT", "1")
    with pytest.raises(ValueError, match="assume_sat contract"):
        VanillaFS.prove(ck, pp, ro(), acc, bad_trace, rng=random.Random(7))

    # without the guard the same fold silently goes through (the documented
    # hazard) ...
    monkeypatch.delenv("MIRA_DEBUG_SAT")
    VanillaFS.prove(ck, pp, ro(), acc, bad_trace, rng=random.Random(7))

    # ... and a satisfying trace passes under the guard
    monkeypatch.setenv("MIRA_DEBUG_SAT", "1")
    good_trace = VanillaFS.generate_plonk_trace(ck, [], advice, pp, ro())
    acc1, _ = VanillaFS.prove(ck, pp, ro(), acc, good_trace, rng=random.Random(7))
    S.is_sat_relaxed(ck, acc1.U, acc1.W)


@pytest.mark.parametrize(
    "circuit_cls", [MulCircuit, TwoGateCircuit, FiboCircuit]
)
def test_fold_evaluator_matches_native_row_vm(circuit_cls):
    """The multi-point device evaluator (polynomial/fold_evaluator.py, the
    GPU fold_eval route) equals the native row VM (the CPU route) at every
    interior fold point, on two different satisfied traces."""
    import numpy as np

    from mira_tpu.polynomial.native_evaluator import available

    if not available():
        pytest.skip("no native toolchain")
    S, advice1, ck = setup(circuit_cls, seed=1)
    _S, advice2, _ck = setup(circuit_cls, seed=2)
    nrow = 1 << S.k
    lf = S.lf

    def cols(advice):
        flat = []
        for col in advice:
            flat.extend(col + [0] * (nrow - len(col)))
        return (lf.encode(flat),)

    W1, W2 = cols(advice1), cols(advice2)
    rng = random.Random(9)
    n_ch = S.num_challenges + 1
    ch1 = [rng.randrange(S.modulus) for _ in range(n_ch)]
    ch2 = [rng.randrange(S.modulus) for _ in range(n_ch)]
    js = [1, 2, 3]
    got = S._fold_evaluator().fold_eval_multi(W1, W2, js, ch1, ch2)
    want = S._native_fold_evaluator().fold_eval_multi(W1, W2, js, ch1, ch2)
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("circuit_cls", [TwoGateCircuit])
def test_decider_eval_via_fold_evaluator_matches_column(circuit_cls):
    """On the GPU route the decider's gate evaluation rides the prover's
    multi-point fold evaluator at j=0 (plonk/structure._eval_full): the homogeneous
    expression at u=1 must equal the compressed one on every row, and the
    j=0 homogeneous evaluation at (challenges, u) must match the column
    evaluator — pins the u=1 identity the routing relies on."""
    import numpy as np

    S, advice, _ck = setup(circuit_cls)
    nrow = 1 << S.k
    lf = S.lf
    W = []
    for col in advice:
        W.extend(col + [0] * (nrow - len(col)))
    Ws = (lf.encode(W),)
    rng = random.Random(5)
    challenges = [rng.randrange(S.modulus) for _ in range(S.num_challenges)]

    pev = S._fold_evaluator()
    for which, ch in (
        ("compressed", challenges + [1]),
        ("homogeneous", challenges + [rng.randrange(S.modulus)]),
    ):
        out = pev.fold_eval_multi(Ws, Ws, [0], ch, [0] * len(ch))[0]
        ev = S._evaluator(which)
        want = ev(Ws, (), ch[:-1] if which == "compressed" else ch)
        assert np.array_equal(np.asarray(out), np.asarray(want)), which
