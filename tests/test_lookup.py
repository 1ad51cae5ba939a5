"""Lookup arguments: SPS 2/3-round paths, log-derivative satisfaction, and
folding with lookup witnesses (reference nifs tests' lookup circuit)."""

import random

import pytest

from mira_tpu.curves.host import BN254_G1, AffinePoint
from mira_tpu.fields.params import BN254_FQ
from mira_tpu.nifs.vanilla import VanillaFS
from mira_tpu.ops.commitment import CommitmentKey
from mira_tpu.ops.poseidon import create_ro
from mira_tpu.plonk.structure import (
    RelaxedPlonkInstance,
    RelaxedPlonkTrace,
    RelaxedPlonkWitness,
    SatError,
)
from mira_tpu.table.runner import CircuitRunner

K = 4


class LookupCircuit:
    """One scalar lookup: advice column `a` must take values from the fixed
    table column `t` (the reference's lookup test circuit shape)."""

    def __init__(self, seed=0):
        self.seed = seed

    def configure(self, cs):
        t = cs.fixed_column()
        a = cs.advice_column()
        q = cs.fixed_column()
        b = cs.advice_column()
        qe, ae, be = cs.query(q), cs.query(a), cs.query(b)
        # a simple gate too, so gates+lookup are both compressed
        cs.create_gate("sq", [qe * (ae * ae - be)])
        cs.lookup("range", [cs.query(a)], [cs.query(t)])
        return (t, a, q, b)

    def synthesize(self, config, ctx):
        t, a, q, b = config
        rng = random.Random(self.seed)
        table = ctx.table
        p = table.modulus
        nrow = table.nrow
        # table column: values 0..nrow-1
        for row in range(nrow):
            table.assign_fixed(t, row, row)
        for row in range(nrow):
            v = rng.randrange(nrow)  # always in the table
            table.assign_fixed(q, row, 1)
            table.assign_advice(a, row, v)
            table.assign_advice(b, row, v * v % p)


class VectorLookupCircuit(LookupCircuit):
    """Vector lookup (a0, a1) in (t0, t1) -> SPS-3 with vector compression."""

    def configure(self, cs):
        t0 = cs.fixed_column()
        t1 = cs.fixed_column()
        a0 = cs.advice_column()
        a1 = cs.advice_column()
        cs.lookup("pair", [cs.query(a0), cs.query(a1)], [cs.query(t0), cs.query(t1)])
        return (t0, t1, a0, a1)

    def synthesize(self, config, ctx):
        t0, t1, a0, a1 = config
        rng = random.Random(self.seed)
        table = ctx.table
        nrow = table.nrow
        for row in range(nrow):
            table.assign_fixed(t0, row, row)
            table.assign_fixed(t1, row, row * 3)
        for row in range(nrow):
            v = rng.randrange(nrow)
            table.assign_advice(a0, row, v)
            table.assign_advice(a1, row, v * 3)


def setup(circuit):
    runner = CircuitRunner(K, circuit, [], BN254_G1)
    S = runner.collect_structure()
    advice = runner.collect_witness()
    ck = CommitmentKey.setup(BN254_G1, K + 3, b"lookup")
    return S, advice, ck


def ro():
    return create_ro(BN254_FQ)


def test_sps2_lookup_roundtrip():
    S, advice, ck = setup(LookupCircuit(1))
    assert S.num_challenges == 2  # lookup without vector => r1, r2... (gate+lookup)
    trace = S.run_sps_protocol(ck, [], advice, ro())
    assert len(trace.u.W_commitments) == 2
    S.is_sat(ck, ro(), trace.u, trace.w)


def test_sps3_vector_lookup_roundtrip():
    S, advice, ck = setup(VectorLookupCircuit(2))
    assert S.has_vector_lookup()
    assert S.num_challenges == 3
    trace = S.run_sps_protocol(ck, [], advice, ro())
    assert len(trace.u.W_commitments) == 3
    S.is_sat(ck, ro(), trace.u, trace.w)


def test_lookup_violation_detected():
    S, advice, ck = setup(LookupCircuit(3))
    bad = [list(col) for col in advice]
    bad[0][0] = (1 << K) + 5  # outside the table
    bad[1][0] = bad[0][0] ** 2 % S.modulus  # keep the gate satisfied
    trace = S.run_sps_protocol(ck, [], bad, ro())
    with pytest.raises(SatError):
        S.is_sat(ck, ro(), trace.u, trace.w)


class MultiLookupCircuit(LookupCircuit):
    """TWO independent scalar lookup arguments — exercises the interleaved
    (l_i,t_i,m_i) per-lookup SPS round-2 layout (plonk/structure.py:435-443)
    with >1 lookup, the case where the reference's own layout notes are
    inconsistent)."""

    def configure(self, cs):
        t0 = cs.fixed_column()
        t1 = cs.fixed_column()
        a0 = cs.advice_column()
        a1 = cs.advice_column()
        cs.lookup("range0", [cs.query(a0)], [cs.query(t0)])
        cs.lookup("range1", [cs.query(a1)], [cs.query(t1)])
        return (t0, t1, a0, a1)

    def synthesize(self, config, ctx):
        t0, t1, a0, a1 = config
        rng = random.Random(self.seed)
        table = ctx.table
        nrow = table.nrow
        for row in range(nrow):
            table.assign_fixed(t0, row, row)
            table.assign_fixed(t1, row, row + nrow)  # disjoint value ranges
        for row in range(nrow):
            table.assign_advice(a0, row, rng.randrange(nrow))
            table.assign_advice(a1, row, rng.randrange(nrow) + nrow)


def _fold_two(circuit_cls, seeds):
    S, advice1, ck = setup(circuit_cls(seeds[0]))
    advice2 = CircuitRunner(K, circuit_cls(seeds[1]), [], BN254_G1).collect_witness()
    pp, vp = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)
    t1 = VanillaFS.generate_plonk_trace(ck, [], advice1, pp, ro())
    t2 = VanillaFS.generate_plonk_trace(ck, [], advice2, pp, ro())
    acc = RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(
            S.curve, S.num_io, S.num_challenges, len(S.round_sizes),
            S.num_g1_elems, S.num_g2_elems,
        ),
        RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes),
    )
    rng = random.Random(11)
    acc1, _ = VanillaFS.prove(ck, pp, ro(), acc, t1, rng=rng)
    S.is_sat_relaxed(ck, acc1.U, acc1.W)
    acc2, proof2 = VanillaFS.prove(ck, pp, ro(), acc1, t2, rng=rng)
    S.is_sat_relaxed(ck, acc2.U, acc2.W)
    U_v = VanillaFS.verify(vp, ro(), ro(), acc1.U, t2.u, proof2)
    assert U_v == acc2.U
    return S


def test_fold_multi_lookup_circuit():
    """Fold a circuit with TWO lookup arguments (interleaved round-2 layout)."""
    S = _fold_two(MultiLookupCircuit, (6, 7))
    assert S.num_lookups() == 2
    assert not S.has_vector_lookup()


def test_fold_vector_lookup_circuit():
    """Fold a vector-lookup circuit — the SPS-3 path (l/t/m then h/g rounds
    split across commitments) had roundtrip coverage but never a fold."""
    S = _fold_two(VectorLookupCircuit, (8, 9))
    assert S.has_vector_lookup()
    assert S.num_challenges == 3


def test_fold_lookup_circuit():
    S, advice1, ck = setup(LookupCircuit(4))
    advice2 = CircuitRunner(K, LookupCircuit(5), [], BN254_G1).collect_witness()
    pp, vp = VanillaFS.setup_params(AffinePoint.generator(BN254_G1), S)
    t1 = VanillaFS.generate_plonk_trace(ck, [], advice1, pp, ro())
    t2 = VanillaFS.generate_plonk_trace(ck, [], advice2, pp, ro())

    acc = RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(
            S.curve, S.num_io, S.num_challenges, len(S.round_sizes),
            S.num_g1_elems, S.num_g2_elems,
        ),
        RelaxedPlonkWitness.zeros(S.lf, S.k, S.round_sizes),
    )
    rng = random.Random(11)
    acc1, proof1 = VanillaFS.prove(ck, pp, ro(), acc, t1, rng=rng)
    S.is_sat_relaxed(ck, acc1.U, acc1.W)
    acc2, proof2 = VanillaFS.prove(ck, pp, ro(), acc1, t2, rng=rng)
    S.is_sat_relaxed(ck, acc2.U, acc2.W)
    U_v = VanillaFS.verify(vp, ro(), ro(), acc1.U, t2.u, proof2)
    assert U_v == acc2.U
