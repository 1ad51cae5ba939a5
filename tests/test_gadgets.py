"""Gadget tests: MainGate parity strings, helper rows, PoseidonChip
off/on-circuit consistency (the reference's critical test pattern)."""

import random

import pytest

from mira_tpu.curves.host import BN254_G1
from mira_tpu.fields.host import field
from mira_tpu.fields.params import BN254_FR
from mira_tpu.gadgets.main_gate import MainGate
from mira_tpu.gadgets.poseidon_chip import PoseidonChip
from mira_tpu.ops.poseidon import PoseidonHash, get_spec
from mira_tpu.table.circuit import ConstraintSystem, RegionCtx, TableData
from mira_tpu.table.mock import MockError, mock_check

Fr = field(BN254_FR)
P = BN254_FR


def fresh_table(k=10, t=5):
    cs = ConstraintSystem()
    config = MainGate.configure(cs, t)
    table = TableData(k, cs, [], P)
    return cs, config, table, RegionCtx(table)


def test_main_gate_expression_parity():
    """The T=2 gate expression must match the reference's exact string
    (reference main_gate.rs:900-935)."""
    from mira_tpu.table.runner import _remap_advice

    cs = ConstraintSystem()
    MainGate.configure(cs, 2)
    assert _remap_advice(cs.gates[0], cs.num_fixed).visualize() == (
        "Z_4 * Z_9 * Z_10 + Z_6 * Z_11 + Z_8 + Z_7 * Z_12 + Z_0 * Z_9 + "
        "Z_2 * Z_9 * Z_9 * Z_9 * Z_9 * Z_9 + Z_1 * Z_10 + "
        "Z_3 * Z_10 * Z_10 * Z_10 * Z_10 * Z_10"
    )


def test_main_gate_grouped_parity():
    """Cross-term shape strings for the T=2 gate
    (reference main_gate.rs test_main_gate_cross_term)."""
    from mira_tpu.polynomial.expression import CompressedGates, QueryIndexContext

    from mira_tpu.table.runner import _remap_advice

    cs = ConstraintSystem()
    MainGate.configure(cs, 2)
    ctx = QueryIndexContext(
        num_selectors=0, num_fixed=cs.num_fixed, num_advice=cs.num_advice,
        num_challenges=0, num_lookups=0,
    )
    compressed = CompressedGates.new(
        [_remap_advice(g, cs.num_fixed) for g in cs.gates], ctx
    )
    e1 = compressed.grouped.get(0)
    e2 = compressed.grouped.get(5)
    assert e1.visualize() == (
        "r_0 * r_0 * r_0 * (Z_10 * Z_9 * Z_4 + r_0 * Z_11 * Z_6 + r_0 * r_0 * Z_8"
        " + r_0 * Z_12 * Z_7) + r_0 * r_0 * r_0 * r_0 * Z_9 * Z_0 + "
        "Z_9 * Z_9 * Z_9 * Z_9 * Z_9 * Z_2 + r_0 * r_0 * r_0 * r_0 * Z_10 * Z_1 + "
        "Z_10 * Z_10 * Z_10 * Z_10 * Z_10 * Z_3"
    )
    assert e2.visualize() == (
        "r_1 * r_1 * r_1 * (Z_14 * Z_13 * Z_4 + r_1 * Z_15 * Z_6 + r_1 * r_1 * Z_8"
        " + r_1 * Z_16 * Z_7) + r_1 * r_1 * r_1 * r_1 * Z_13 * Z_0 + "
        "Z_13 * Z_13 * Z_13 * Z_13 * Z_13 * Z_2 + r_1 * r_1 * r_1 * r_1 * Z_14 * Z_1 + "
        "Z_14 * Z_14 * Z_14 * Z_14 * Z_14 * Z_3"
    )


def test_main_gate_helpers_satisfy():
    cs, config, table, ctx = fresh_table()
    mg = MainGate(config)
    rng = random.Random(0)
    a = mg.assign_value(ctx, rng.randrange(P))
    b = mg.assign_value(ctx, rng.randrange(P))
    s = mg.add(ctx, a, b)
    assert s.value == (a.value + b.value) % P
    d = mg.sub(ctx, a, b)
    m = mg.mul(ctx, a, b)
    assert m.value == a.value * b.value % P
    c = mg.mul_by_const(ctx, a, 12345)
    w = mg.add_with_const(ctx, a, 777)
    assert w.value == (a.value + 777) % P
    bit = mg.assign_bit(ctx, 1)
    sel = mg.conditional_select(ctx, a, b, bit)
    assert sel.value == a.value
    r, inv = mg.invert_with_flag(ctx, m)
    assert r.value == 0 and inv.value == pow(m.value, -1, P)
    z = mg.assign_value(ctx, 0)
    rz = mg.is_zero_term(ctx, z)
    assert rz.value == 1
    eq = mg.is_equal_term(ctx, a, a)
    assert eq.value == 1
    mg.assert_equal_const(ctx, w, (a.value + 777) % P)
    mock_check(cs, table)


def test_main_gate_bit_decomposition():
    cs, config, table, ctx = fresh_table(k=11)
    mg = MainGate(config)
    v = 0xDEADBEEF12345678
    a = mg.assign_value(ctx, v)
    bits = mg.le_num_to_bits(ctx, a, 255)
    assert sum(1 << i for i, b in enumerate(bits) if b.value) == v
    num = mg.le_bits_to_num(ctx, bits)
    assert num.value == v
    mock_check(cs, table)


def test_main_gate_unsatisfied_detected():
    cs, config, table, ctx = fresh_table()
    mg = MainGate(config)
    a = mg.assign_value(ctx, 5)
    b = mg.assign_value(ctx, 7)
    mg.add(ctx, a, b)
    # corrupt the out cell of the add row (row 2, out column)
    table.advice[config.out.index][2] = 999
    with pytest.raises(MockError):
        mock_check(cs, table)


@pytest.mark.parametrize("n_inputs", [3, 4, 5])
def test_poseidon_chip_matches_host(n_inputs):
    """Off-circuit vs on-circuit sponge consistency (T=5/RATE=4 IVC spec)."""
    spec = get_spec(BN254_FR, 5, 4, 10, 10)
    cs, config, table, ctx = fresh_table(k=11, t=5)
    chip = PoseidonChip(config, spec)
    inputs = [Fr(i * 17 + 3).v for i in range(n_inputs)]
    chip.update(inputs)
    out = chip.squeeze(ctx)

    host = PoseidonHash(spec)
    host.update([Fr(v) for v in inputs])
    # full-field output (state[1]); squeeze() truncation happens downstream
    host_out = host.output(Fr, 255)
    assert out.value == host_out.v
    mock_check(cs, table)


def test_merkle_hash_golden_vectors():
    """Parameter parity with the reference Merkle gadget: node hash is
    Poseidon(T=5, RATE=4, R_F=R_P=10) truncated to 255 bits
    (/root/reference/src/gadgets/merkle_tree_gadget/mod.rs:1-2 sets T=5,
    RATE=T-1; off_circuit.rs:15-24 sets R_F=R_P=10, NUM_BITS=255).  These
    golden values
    pin the whole stack: Grain constants, sponge padding, truncation, and
    the default-subtree chain."""
    from mira_tpu.fields.params import BN254_FR
    from mira_tpu.gadgets.merkle import Tree, merkle_hash

    assert merkle_hash(BN254_FR, 0, 0) == (
        20597641957626941655698106174391564583568735863717244585578221365142440956808
    )
    t = Tree(BN254_FR)
    assert t.root() == (
        20475426438002783376919794005436757716717490480185211223545241072227109064620
    )
    proof = t.update_leaf(5, 123456789)
    assert t.root() == (
        20208834983337481817471050070317191274894735343921820150618473159814746033944
    )
    assert proof.verify(BN254_FR)
