"""ECC chip and BigUint chip: off-circuit vs in-circuit consistency + mock
satisfaction (the reference's gadget test pattern)."""

import random

import pytest

from mira_tpu.curves.host import BN254_G1, GRUMPKIN, AffinePoint
from mira_tpu.fields.params import BN254_FQ, BN254_FR
from mira_tpu.gadgets.bignum import BigUintMulModChip, OverflowingBigUint
from mira_tpu.gadgets.ecc import EccChip
from mira_tpu.gadgets.main_gate import MainGate
from mira_tpu.table.circuit import ConstraintSystem, RegionCtx, TableData
from mira_tpu.table.mock import mock_check


def fresh(k, t, modulus):
    cs = ConstraintSystem()
    config = MainGate.configure(cs, t)
    table = TableData(k, cs, [], modulus)
    return cs, config, table, RegionCtx(table)


def test_ecc_add_double():
    # circuit over grumpkin's base field = Fr; curve = grumpkin
    cs, config, table, ctx = fresh(12, 5, BN254_FR)
    chip = EccChip(config, GRUMPKIN)
    rng = random.Random(0)
    a = AffinePoint.random(GRUMPKIN, rng)
    b = AffinePoint.random(GRUMPKIN, rng)
    inf = AffinePoint.identity(GRUMPKIN)

    pa = chip.assign_point(ctx, a)
    pb = chip.assign_point(ctx, b)
    pinf = chip.assign_point(ctx, inf)

    assert chip.to_host(chip.add(ctx, pa, pb)) == a.add(b)
    assert chip.to_host(chip.add(ctx, pa, pa)) == a.double()
    assert chip.to_host(chip.add(ctx, pa, pinf)) == a
    assert chip.to_host(chip.add(ctx, pinf, pb)) == b
    neg_a = chip.negate(ctx, pa)
    assert chip.to_host(chip.add(ctx, pa, neg_a)) == inf
    assert chip.to_host(chip.double(ctx, pa)) == a.double()
    mock_check(cs, table)


@pytest.mark.parametrize("scalar", [1, 5, 0xDEADBEEF, None])
def test_ecc_scalar_mul(scalar):
    cs, config, table, ctx = fresh(14, 5, BN254_FR)
    chip = EccChip(config, GRUMPKIN)
    mg = chip.main_gate
    rng = random.Random(3)
    p = AffinePoint.random(GRUMPKIN, rng)
    if scalar is None:
        scalar = rng.randrange(GRUMPKIN.scalar_modulus) % BN254_FR  # fits base field
    ap = chip.assign_point(ctx, p)
    lam = mg.assign_value(ctx, scalar)
    bits = mg.le_num_to_bits(ctx, lam, 255)
    out = chip.scalar_mul(ctx, ap, bits)
    assert chip.to_host(out) == p.scalar_mul(scalar)
    mock_check(cs, table)


def test_ecc_scalar_mul_infinity():
    cs, config, table, ctx = fresh(14, 5, BN254_FR)
    chip = EccChip(config, GRUMPKIN)
    mg = chip.main_gate
    ap = chip.assign_point(ctx, AffinePoint.identity(GRUMPKIN))
    lam = mg.assign_value(ctx, 12345)
    bits = mg.le_num_to_bits(ctx, lam, 255)
    out = chip.scalar_mul(ctx, ap, bits)
    assert chip.to_host(out) == AffinePoint.identity(GRUMPKIN)
    mock_check(cs, table)


def test_bignum_mult_mod():
    """mult_mod of scalar-field (Fq) values inside an Fr circuit."""
    cs, config, table, ctx = fresh(13, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    rng = random.Random(1)
    m = BN254_FQ  # the nonnative ("wrong-field") modulus
    a, b = rng.randrange(m), rng.randrange(m)

    a_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(a)]
    b_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(b)]
    res = chip.mult_mod(ctx, a_cells, b_cells, m)
    from mira_tpu.gadgets.bignum import limbs_to_int_bn

    got = limbs_to_int_bn([c.value for c in res.remainder], chip.limb_width)
    assert got == a * b % m
    mock_check(cs, table)


def test_bignum_red_mod_and_sum():
    cs, config, table, ctx = fresh(13, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    rng = random.Random(2)
    m = BN254_FQ
    a, b = rng.randrange(m), rng.randrange(m)
    a_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(a)]
    b_limbs = chip.to_limbs(b)
    mw = (1 << chip.limb_width) - 1
    _, summed = chip.assign_sum(ctx, OverflowingBigUint(a_cells, mw), b_limbs)
    res = chip.red_mod(ctx, summed, m)
    from mira_tpu.gadgets.bignum import limbs_to_int_bn

    got = limbs_to_int_bn([c.value for c in res.remainder], chip.limb_width)
    assert got == (a + b) % m
    mock_check(cs, table)


def test_bignum_cell_to_limbs_roundtrip():
    cs, config, table, ctx = fresh(12, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    v = 0x1234567890ABCDEF1234567890ABCDEF
    cell = mg.assign_value(ctx, v)
    limbs = chip.from_assigned_cell_to_limbs(ctx, cell)
    from mira_tpu.gadgets.bignum import limbs_to_int_bn

    assert limbs_to_int_bn([c.value for c in limbs], chip.limb_width) == v
    mock_check(cs, table)


def test_g2_chip_ops():
    """G2EccChip add/double/scalar_mul vs host G2 arithmetic (circuit over
    the bn254 BASE field, where G2 coordinates live)."""
    from mira_tpu.curves.host import G2Point
    from mira_tpu.gadgets.fp12_chip import G2EccChip

    cs, config, table, ctx = fresh(17, 5, BN254_FQ)
    chip = G2EccChip(config)
    mg = chip.main_gate
    rng = random.Random(5)
    a = G2Point.random(rng)
    b = G2Point.random(rng)

    def to_host(ap):
        from mira_tpu.curves.host import Fq2, G2Point as HG2
        from mira_tpu.fields.host import field

        F = field(BN254_FQ)
        if all(c.value == 0 for c in (*ap.x, *ap.y)):
            return HG2.identity()
        return HG2(Fq2(F(ap.x[0].value), F(ap.x[1].value)),
                   Fq2(F(ap.y[0].value), F(ap.y[1].value)))

    pa = chip.assign_g2_point(ctx, a)
    pb = chip.assign_g2_point(ctx, b)
    pinf = chip.assign_g2_point(ctx, None)
    assert to_host(chip.add_g2(ctx, pa, pb)) == a.add(b)
    assert to_host(chip.add_g2(ctx, pa, pa)) == a.double()
    assert to_host(chip.add_g2(ctx, pa, pinf)) == a
    assert to_host(chip.double_g2(ctx, pa)) == a.double()
    neg = chip.negate_g2(ctx, pa)
    assert to_host(chip.add_g2(ctx, pa, neg)) == G2Point.identity()

    k = 0xABCDEF0123
    lam = mg.assign_value(ctx, k)
    bits = mg.le_num_to_bits(ctx, lam, 255)
    assert to_host(chip.scalar_mul(ctx, pa, bits)) == a.scalar_mul(k)
    mock_check(cs, table)


def test_fp12_chip_mul_scalar_mul():
    """Fp12Chip in-circuit mul / scalar_mul vs host Tuple12 (the reference's
    fp12 impl-equivalence test pattern)."""
    from mira_tpu.curves.host import Tuple12
    from mira_tpu.fields.host import field
    from mira_tpu.gadgets.fp12_chip import Fp12Chip

    F = field(BN254_FQ)
    cs, config, table, ctx = fresh(17, 5, BN254_FQ)
    chip = Fp12Chip(config)
    mg = chip.main_gate
    rng = random.Random(6)
    g = Tuple12.generator(F)
    a = g.scalar_mul(rng.randrange(1 << 64))
    b = g.scalar_mul(rng.randrange(1 << 64))

    def assign(t):
        from mira_tpu.gadgets.fp12_chip import AssignedTuple12

        return AssignedTuple12([mg.assign_value(ctx, e.v) for e in t.elements])

    ca, cb = assign(a), assign(b)
    got = chip.mul(ctx, ca, cb)
    want = a.mul(b)
    assert [c.value for c in got.elements] == [e.v for e in want.elements]

    k = 0x1F2E3D
    lam = mg.assign_value(ctx, k)
    bits = mg.le_num_to_bits(ctx, lam, 24)
    got2 = chip.scalar_mul(ctx, ca, bits)
    want2 = a.scalar_mul(k)
    assert [c.value for c in got2.elements] == [e.v for e in want2.elements]
    mock_check(cs, table)


# ---------------------------------------------------------------------------
# Bignum edge cases (the intent of the reference's
# /root/reference/src/gadgets/nonnative/bn/big_uint_mul_mod_chip/tests.rs)
# ---------------------------------------------------------------------------


def _mult_mod_case(a, b, m, k=14):
    cs, config, table, ctx = fresh(k, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    a_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(a)]
    b_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(b)]
    res = chip.mult_mod(ctx, a_cells, b_cells, m)
    from mira_tpu.gadgets.bignum import limbs_to_int_bn

    got = limbs_to_int_bn([c.value for c in res.remainder], chip.limb_width)
    assert got == a * b % m, f"mult_mod({a}, {b}) mod {m}"
    mock_check(cs, table)
    return cs, table, res


@pytest.mark.parametrize(
    "a,b",
    [
        (0, 0),
        (0, 12345),
        (1, BN254_FQ - 1),
        (BN254_FQ - 1, BN254_FQ - 1),  # max operands: max-word overflow path
        (2**255 - 1 - BN254_FQ, BN254_FQ - 2),
    ],
    ids=["zero-zero", "zero-x", "one-max", "max-max", "nearmax"],
)
def test_bignum_mult_mod_edges(a, b):
    _mult_mod_case(a % BN254_FQ, b % BN254_FQ, BN254_FQ)


def test_bignum_mult_mod_other_modulus():
    """Different nonnative modulus => different carry/group parameters."""
    m = (1 << 255) - 19
    _mult_mod_case(m - 1, m - 2, m)


def _red_mod_case(a, b, m, k=14):
    cs, config, table, ctx = fresh(k, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    a_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(a)]
    mw = (1 << chip.limb_width) - 1
    _, summed = chip.assign_sum(ctx, OverflowingBigUint(a_cells, mw), chip.to_limbs(b))
    res = chip.red_mod(ctx, summed, m)
    from mira_tpu.gadgets.bignum import limbs_to_int_bn

    got = limbs_to_int_bn([c.value for c in res.remainder], chip.limb_width)
    assert got == (a + b) % m
    mock_check(cs, table)


@pytest.mark.parametrize(
    "a,b",
    [
        (0, 0),                          # q = 0, r = 0
        (5, 0),                          # value < m: q = 0 path
        (BN254_FQ - 1, 1),               # value == m exactly: r = 0, q = 1
        (BN254_FQ - 1, BN254_FQ - 1),    # max sum: carry-boundary grouping
    ],
    ids=["zero", "below-mod", "exact-mod", "max-sum"],
)
def test_bignum_red_mod_edges(a, b):
    _red_mod_case(a, b, BN254_FQ)


def test_bignum_mult_mod_tampered_remainder_rejected():
    """Soundness: flipping one assigned advice cell after synthesis must make
    the mock prover reject (the reference's MockProver err-pattern tests)."""
    from mira_tpu.table.mock import MockError

    cs, table, res = _mult_mod_case(987654321, 123456789, BN254_FQ)
    cell = res.remainder[0].cell
    table.advice[cell.column.index][cell.row] ^= 1
    with pytest.raises(MockError):
        mock_check(cs, table)


def test_bignum_is_equal_rejects_unequal_witness():
    """The prover-side carry assertion fires on non-equal bignats."""
    cs, config, table, ctx = fresh(13, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    mw = (1 << chip.limb_width) - 1
    a_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(1234)]
    b_cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(1235)]
    with pytest.raises(AssertionError):
        chip.is_equal(
            ctx,
            OverflowingBigUint(a_cells, mw),
            OverflowingBigUint(b_cells, mw),
        )


def test_bignum_to_le_bits_max_value():
    cs, config, table, ctx = fresh(14, 5, BN254_FR)
    chip = BigUintMulModChip(config)
    mg = MainGate(config)
    v = BN254_FQ - 1
    cells = [mg.assign_value(ctx, l) for l in chip.to_limbs(v)]
    bits = chip.to_le_bits(ctx, cells)
    got = sum(int(b.value) << i for i, b in enumerate(bits))
    assert got == v
    mock_check(cs, table)
