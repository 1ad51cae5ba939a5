"""IVC layer tests: off/on-circuit instance-hash consistency, fold-chip
consistency vs the off-circuit fold, and the trivial end-to-end IVC
(the minimum slice of SURVEY.md §7 step 8)."""

import random

import pytest

from mira_tpu.curves.host import BN254_G1, GRUMPKIN, AffinePoint, Tuple12
from mira_tpu.fields.host import field
from mira_tpu.gadgets.main_gate import MainGate
from mira_tpu.gadgets.poseidon_chip import PoseidonChip
from mira_tpu.ivc.fold_chip import FoldRelaxedPlonkInstanceChip
from mira_tpu.ivc.instance_computation import (
    compute_instance_hash,
    compute_instance_hash_on_circuit,
)
from mira_tpu.ivc.ivc import IVC
from mira_tpu.ivc.public_params import (
    RO_R_F,
    RO_R_P,
    RO_RATE,
    RO_T,
    CircuitSide,
    PublicParams,
)
from mira_tpu.ivc.step_circuit import TrivialCircuit
from mira_tpu.ops.mock_commitment import MockCommitmentKey
from mira_tpu.ops.poseidon import PoseidonHash, get_spec
from mira_tpu.plonk.structure import PlonkInstance, RelaxedPlonkInstance
from mira_tpu.table.circuit import ConstraintSystem, RegionCtx, TableData
from mira_tpu.table.mock import mock_check

LIMB_WIDTH, LIMBS_COUNT = 32, 10


def random_relaxed(rng, curve=GRUMPKIN, n_w=1, n_ch=0):
    """Random-ish relaxed instance over `curve` (instances live in the
    curve's scalar field)."""
    Fb = field(curve.base_modulus)
    return RelaxedPlonkInstance(
        curve=curve,
        W_commitments=[AffinePoint.random(curve, rng) for _ in range(n_w)],
        E_commitment=AffinePoint.random(curve, rng),
        instance=[rng.randrange(1 << 250) for _ in range(2)],
        challenges=[rng.randrange(1 << 128) for _ in range(n_ch)],
        u=rng.randrange(1 << 120),
        g1_elements=[],
        g2_elements=[],
        gt_element=Tuple12.one(Fb),
    )


def random_fresh(rng, curve=GRUMPKIN, n_w=1, n_ch=0):
    return PlonkInstance(
        curve=curve,
        W_commitments=[AffinePoint.random(curve, rng) for _ in range(n_w)],
        instance=[rng.randrange(1 << 250) for _ in range(2)],
        challenges=[rng.randrange(1 << 128) for _ in range(n_ch)],
        g1_elements=[],
        g2_elements=[],
    )


def fresh_table(k=15):
    # circuit over grumpkin base field = Fr (primary side layout)
    cs = ConstraintSystem()
    config = MainGate.configure(cs, 5)
    table = TableData(k, cs, [], BN254_G1.scalar_modulus)
    return cs, config, table, RegionCtx(table)


def test_instance_hash_off_on_consistency():
    """The off-circuit and on-circuit instance hashes must agree bit-exactly
    (reference instance_computation.rs consistency test)."""
    rng = random.Random(42)
    relaxed = random_relaxed(rng)
    cs, config, table, ctx = fresh_table()

    spec = get_spec(BN254_G1.scalar_modulus, RO_T, RO_RATE, RO_R_F, RO_R_P)
    pp_hash = AffinePoint.random(GRUMPKIN, rng)
    step = 3
    z_0 = [rng.randrange(table.modulus) for _ in range(2)]
    z_i = [rng.randrange(table.modulus) for _ in range(2)]

    off = compute_instance_hash(
        PoseidonHash(spec), pp_hash, step, z_0, z_i, relaxed, LIMB_WIDTH, LIMBS_COUNT
    )

    chip = FoldRelaxedPlonkInstanceChip(relaxed, LIMB_WIDTH, LIMBS_COUNT, config)
    mg = MainGate(config)
    # assign the witness (absorbing into a throwaway RO), then hash on-circuit
    w, _r = chip.assign_witness_with_challenge(
        ctx, pp_hash, random_fresh(rng), [], [], PoseidonChip(config, spec)
    )
    from mira_tpu.gadgets.ecc import EccChip

    ecc = EccChip(config, GRUMPKIN)
    pp_cell = ecc.assign_point(ctx, pp_hash)
    step_cell = mg.assign_value(ctx, step)
    z0_cells = [mg.assign_value(ctx, v) for v in z_0]
    zi_cells = [mg.assign_value(ctx, v) for v in z_i]
    on = compute_instance_hash_on_circuit(
        PoseidonChip(config, spec), ctx, config, pp_cell, step_cell,
        z0_cells, zi_cells, w.assigned_relaxed,
    )
    assert on.value == off
    mock_check(cs, table)


def test_fold_chip_matches_off_circuit_fold():
    """In-circuit fold == off-circuit RelaxedPlonkInstance.fold for the same
    challenge (reference fold chip tests)."""
    rng = random.Random(7)
    relaxed = random_relaxed(rng, n_w=1, n_ch=0)
    fresh = random_fresh(rng, n_w=1, n_ch=0)
    cross = [AffinePoint.random(GRUMPKIN, rng) for _ in range(5)]

    cs, config, table, ctx = fresh_table(k=17)
    spec = get_spec(BN254_G1.scalar_modulus, RO_T, RO_RATE, RO_R_F, RO_R_P)
    pp_hash = AffinePoint.random(GRUMPKIN, rng)

    chip = FoldRelaxedPlonkInstanceChip(relaxed, LIMB_WIDTH, LIMBS_COUNT, config)
    ro_chip = PoseidonChip(config, spec)
    w, r_bits = chip.assign_witness_with_challenge(
        ctx, pp_hash, fresh, cross, [], ro_chip
    )
    result = chip.fold(ctx, w, r_bits)
    got = result.assigned_result_of_fold.to_relaxed_plonk_instance(
        GRUMPKIN, LIMB_WIDTH, LIMBS_COUNT
    )

    # off-circuit twin: same challenge value
    r_value = sum((1 << i) * b.value for i, b in enumerate(r_bits))
    want = relaxed.fold(fresh, cross, [], r_value)
    assert got.W_commitments == want.W_commitments
    assert got.E_commitment == want.E_commitment
    assert got.instance == want.instance
    assert got.challenges == want.challenges
    assert got.u == want.u
    mock_check(cs, table)


import os


def _trivial_pp():
    K = 17
    primary_ck = MockCommitmentKey(BN254_G1, 21, b"bn256")
    secondary_ck = MockCommitmentKey(GRUMPKIN, 21, b"grumpkin")
    return PublicParams(
        CircuitSide(TrivialCircuit(arity=1), primary_ck, K),
        CircuitSide(TrivialCircuit(arity=1), secondary_ck, K),
        BN254_G1,
        GRUMPKIN,
    )


def test_trivial_ivc_zero_step():
    """IVC initialization (zero step on both curves): instance hashes and
    relaxed traces must verify before any fold."""
    pp = _trivial_pp()
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    ivc.verify(strict=False)
    assert ivc.step == 1


@pytest.mark.skipif(
    not os.environ.get("MIRA_RUN_SLOW"),
    reason="~11min CPU e2e; set MIRA_RUN_SLOW=1 (verified green in round 1)",
)
def test_trivial_ivc_end_to_end():
    """The full minimum slice: two-curve IVC over trivial step circuits,
    two fold steps, strict verification (matches examples/trivial)."""
    pp = _trivial_pp()
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22],
              debug_mode=True)
    ivc.fold_step()
    ivc.fold_step()
    ivc.verify(strict=True)
    assert ivc.step == 3


def test_ivc_checkpoint_roundtrip(tmp_path):
    """save_checkpoint/load_checkpoint: a restored IVC continues folding and
    verifies identically to the uninterrupted run (ivc/checkpoint.py)."""
    pp = _trivial_pp()
    ivc = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    path = str(tmp_path / "ivc_ckpt.npz")
    ivc.save_checkpoint(path)

    ivc2 = IVC(pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22])
    ivc2.load_checkpoint(path)
    assert ivc2.step == ivc.step
    U1 = ivc.secondary.relaxed_trace.U
    U2 = ivc2.secondary.relaxed_trace.U
    assert U1.instance == U2.instance
    assert U1.W_commitments == U2.W_commitments
    assert [c.v for c in U1.gt_element.elements] == [
        c.v for c in U2.gt_element.elements
    ]
    assert ivc2.secondary_trace.u.instance == ivc.secondary_trace.u.instance
    ivc2.verify(strict=False)

    # IVC.resume: same restore WITHOUT paying a fresh zero step first —
    # state must match the load_checkpoint path field for field and the
    # resumed IVC must verify.
    ivc3 = IVC.resume(
        pp, TrivialCircuit(arity=1), TrivialCircuit(arity=1), path
    )
    assert ivc3.step == ivc.step
    assert ivc3.primary.z_0 == ivc.primary.z_0
    assert ivc3.primary.z_i == ivc.primary.z_i
    U3 = ivc3.secondary.relaxed_trace.U
    assert U3.instance == U1.instance
    assert U3.W_commitments == U1.W_commitments
    assert ivc3.secondary_trace.u.instance == ivc.secondary_trace.u.instance
    ivc3.verify(strict=False)


@pytest.mark.slow
@pytest.mark.skipif(
    not os.environ.get("MIRA_RUN_SLOW"),
    reason="2x 2-step k=17 IVC on the CPU mesh; set MIRA_RUN_SLOW=1",
)
def test_ivc_fold_step_mesh_matches_single():
    """IVC.fold_step(mesh=) — cross-term eval+commits, SPS witness commits,
    and the witness RLC fold all sharded over the 8-virtual-device CPU mesh —
    must produce the same instances, step for step, as the single-device
    run (substitutes for distributed tests per SURVEY §4,
    rayon sites /root/reference/src/plonk/mod.rs:653-907,1097-1134)."""
    from mira_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)

    def two_steps(mesh_arg):
        pp = _trivial_pp()
        ivc = IVC(
            pp, TrivialCircuit(arity=1), [11], TrivialCircuit(arity=1), [22]
        )
        ivc.fold_step(mesh=mesh_arg)
        ivc.fold_step(mesh=mesh_arg)
        ivc.verify(strict=False)
        return ivc

    a = two_steps(None)
    b = two_steps(mesh)
    for ca, cb in (
        (a.primary.relaxed_trace.U, b.primary.relaxed_trace.U),
        (a.secondary.relaxed_trace.U, b.secondary.relaxed_trace.U),
    ):
        assert ca.instance == cb.instance
        assert ca.W_commitments == cb.W_commitments
        assert ca.E_commitment == cb.E_commitment
        assert ca.challenges == cb.challenges and ca.u == cb.u
    assert a.secondary_trace.u.instance == b.secondary_trace.u.instance
    lf = a.pp.primary.S.lf
    for wa, wb in zip(
        a.primary.relaxed_trace.W.W, b.primary.relaxed_trace.W.W
    ):
        assert lf.decode(wa) == lf.decode(wb)
    assert lf.decode(a.primary.relaxed_trace.W.E) == lf.decode(
        b.primary.relaxed_trace.W.E
    )
