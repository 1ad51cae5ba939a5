"""The device fold evaluator (polynomial/fold_evaluator.py): the op-list loop
against the python row evaluator and the native row VM on random gate
expressions, and the register program it runs."""

import random

import numpy as np
import pytest

from mira_tpu.fields.limbs import limb_field
from mira_tpu.fields.params import BN254_FR
from mira_tpu.polynomial.evaluator import EvalDomain, eval_rows_host
from mira_tpu.polynomial.expression import (
    Challenge,
    Const,
    Neg,
    Poly,
    Product,
    Query,
    Scaled,
    Sum,
)
from mira_tpu.polynomial.fold_evaluator import (
    FoldEvaluator,
    compile_ops,
    query_layout,
    register_program,
)
from mira_tpu.polynomial.native_evaluator import NativeFoldEvaluator

P = BN254_FR
NROW = 16
N_SEL, N_FIX, N_ADV, N_CH = 2, 2, 3, 2


def _random_expr(rng, depth):
    if depth == 0 or rng.random() < 0.2:
        kind = rng.randrange(4)
        if kind == 0:
            return Poly(Query(rng.randrange(N_SEL + N_FIX + N_ADV),
                              rng.choice([-1, 0, 0, 1])))
        if kind == 1:
            return Challenge(rng.randrange(N_CH))
        if kind == 2:
            return Const(rng.randrange(P))
        return Poly(Query(N_SEL + N_FIX + rng.randrange(N_ADV)))
    op = rng.randrange(5)
    a = _random_expr(rng, depth - 1)
    if op == 0:
        return Neg(a)
    if op == 1:
        return Scaled(a, rng.randrange(P))
    b = _random_expr(rng, depth - 1)
    return Sum(a, b) if op == 2 else Product(a, b)


def _tables(rng):
    selectors = [[rng.random() < 0.5 for _ in range(NROW)]
                 for _ in range(N_SEL)]
    fixed = [[rng.randrange(P) for _ in range(NROW)] for _ in range(N_FIX)]
    return selectors, fixed


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_device_loop_matches_host_and_native(seed):
    """P(W1 + j*W2) at j = 0, 1, 2 on a random expression with rotations,
    negations, scalings, constants and witness-free subtrees: the device
    loop equals the python row evaluator and the native row VM."""
    rng = random.Random(seed)
    lf = limb_field(P)
    expr = Sum(_random_expr(rng, 6), _random_expr(rng, 6))
    selectors, fixed = _tables(rng)
    w1 = [rng.randrange(P) for _ in range(N_ADV * NROW)]
    w2 = [rng.randrange(P) for _ in range(N_ADV * NROW)]
    ch1 = [rng.randrange(P) for _ in range(N_CH)]
    ch2 = [rng.randrange(P) for _ in range(N_CH)]
    js = [0, 1, 2]
    args = (expr, P, N_ADV, 0, selectors, fixed, NROW)
    W1, W2 = (lf.encode(w1),), (lf.encode(w2),)

    got = np.asarray(FoldEvaluator(*args).fold_eval_multi(W1, W2, js, ch1, ch2))
    native = NativeFoldEvaluator(*args).fold_eval_multi(W1, W2, js, ch1, ch2)
    assert np.array_equal(got, native)
    for i, j in enumerate(js):
        dom = EvalDomain(
            modulus=P, num_advice=N_ADV, num_lookup=0,
            challenges=[(a + j * b) % P for a, b in zip(ch1, ch2)],
            selectors=selectors, fixed=fixed,
            W1s=[[(a + j * b) % P for a, b in zip(w1, w2)]], W2s=[],
        )
        assert lf.decode(got[i]) == eval_rows_host(expr, dom), f"j={j}"


def test_bare_leaf_expression():
    """An expression that is one queried column still runs the loop."""
    rng = random.Random(4)
    lf = limb_field(P)
    selectors, fixed = _tables(rng)
    expr = Poly(Query(N_SEL, 1))  # fixed column 0, rotated by one row
    W = (lf.encode([0] * (N_ADV * NROW)),)
    got = FoldEvaluator(expr, P, N_ADV, 0, selectors, fixed, NROW) \
        .fold_eval_multi(W, W, [1], [], [])
    col = fixed[0]
    assert lf.decode(np.asarray(got)[0]) == col[1:] + col[:1]


@pytest.mark.parametrize("length", [8, 64])
def test_register_program_reuses_dead_temporaries(length):
    """A chain x*(x + (x*(x + ...))) needs two live temporaries however long
    it is.  The program opens with W1 + j*W2 per fold column, keeps one
    (is_mul, a, b, dst) row per op, negates by multiplying by the -1 slot,
    and pads rows to a multiple of 64 and the file to a multiple of 32."""
    x = Poly(Query(N_SEL + N_FIX))
    expr = x
    for i in range(length):
        expr = Product(x, expr) if i % 2 else Neg(Sum(x, expr))
    selectors, fixed = _tables(random.Random(5))
    qslot, advice, static = query_layout(
        expr, N_ADV, 0, selectors, fixed, NROW)
    ops, _, c64 = compile_ops(expr, qslot, P)
    n_ch = 1
    prog, out_reg, n_file = register_program(
        ops, len(static), len(advice), n_ch, len(c64))
    n_aq = len(advice)
    minus_one = len(static) + 2 * n_aq + 1 + n_ch + len(c64)
    n_real = 2 * n_aq + length + length // 2  # fold, then add, mul by -1, mul
    real, pad = prog[:n_real], prog[n_real:]
    assert len(prog) % 64 == 0 and len(pad) < 64
    assert n_file % 32 == 0
    assert real[:, 1:].max() <= minus_one + 2  # at most two temporaries
    assert out_reg == real[-1, 3]
    assert set(real[:, 0]) == {0, 1}
    assert (real[real[:, 2] == minus_one, 0] == 1).all()
    scratch = real[:, 3].max() + 1  # past the last temporary
    assert (pad[:, 0] == 0).all() and (pad[:, 1:] == scratch).all()
    assert scratch < n_file
