"""Multi-point fold evaluator on the device: P(W1 + j*W2) at every fold point j.

The expression is compiled once into a linear op list with common
subexpressions shared (`compile_ops`, the program the native row VM of
native_evaluator.py also runs).  On the device a jitted loop runs that list
over whole columns: every register is one limbs-major (16, nrow) column
(fields/limbs_major.py) and every op is one whole-row add or Montgomery
multiply.  The op list is an argument of the program, not part of it, so
XLA compiles one multiply and one add however large the gate polynomial is;
straight-line code for the k=17 step-folding circuit (about 100 multiplies)
took XLA:GPU over ten minutes to compile.

Registers are reused once their value is dead, so the register file holds
the queried columns plus the live temporaries; program and file are padded
to fixed steps, so one compiled loop serves most gate polynomials of a
field and row count.  With a mesh the register
file is sharded by rows and GSPMD partitions the loop (rotations become
collective permutes).

This is the device replacement for the reference's row-parallel interpreted
loop (/root/reference/src/plonk/mod.rs:461-530,
/root/reference/src/nifs/vanilla/mod.rs:109-116) — SURVEY.md §7 hard part
"row-parallel gate evaluation".
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.limbs import LIMB_BITS, NUM_LIMBS, limb_field
from ..fields.limbs_major import tfield
from ..fields.native64 import limbs64_to_16
from .evaluator import advice_round_col
from .expression import (
    Challenge,
    Const,
    Expression,
    Neg,
    Poly,
    Product,
    Query,
    Scaled,
    Sum,
)

_MONT_R = 1 << (LIMB_BITS * NUM_LIMBS)

OP_LOAD_STATIC = 0
OP_LOAD_FOLD = 1
OP_LOAD_CH = 2
OP_LOAD_CONST = 3
OP_ADD = 4
OP_MUL = 5
OP_NEG = 6
OP_OUTPUT = 7


def _split_scalar_subtrees(expr: Expression, n_ch_base: int):
    """Replace every maximal witness-free subtree (Const/Challenge ops only)
    with a synthetic Challenge slot.

    Those subtrees are the same on every row, so evaluating them per row
    wastes full-width muls; after this rewrite every device field op has at
    least one witness-dependent operand.  Returns (rewritten expr,
    [scalar exprs]); scalar s is bound to Challenge(n_ch_base + s) and its
    value is computed host-side per fold point."""
    free_memo = {}

    def is_free(e) -> bool:
        key = id(e)
        if key not in free_memo:
            if isinstance(e, (Const, Challenge)):
                free_memo[key] = True
            elif isinstance(e, (Neg, Scaled)):
                free_memo[key] = is_free(e.a)
            elif isinstance(e, (Sum, Product)):
                free_memo[key] = is_free(e.a) and is_free(e.b)
            else:  # Poly or unknown
                free_memo[key] = False
        return free_memo[key]

    scalars: List[Expression] = []

    def rewrite(e):
        if is_free(e) and not isinstance(e, (Const, Challenge)):
            scalars.append(e)
            return Challenge(n_ch_base + len(scalars) - 1)
        if isinstance(e, Neg):
            return Neg(rewrite(e.a))
        if isinstance(e, Scaled):
            return Scaled(rewrite(e.a), e.k)
        if isinstance(e, Sum):
            return Sum(rewrite(e.a), rewrite(e.b))
        if isinstance(e, Product):
            return Product(rewrite(e.a), rewrite(e.b))
        return e

    return rewrite(expr), scalars


def _eval_scalar(expr: Expression, modulus: int, ch_vals: Sequence[int]) -> int:
    return expr.evaluate(
        constant=lambda c: c % modulus,
        poly=lambda q: (_ for _ in ()).throw(
            ValueError("scalar subtree queried a column")
        ),
        challenge=lambda i: ch_vals[i] % modulus,
        negated=lambda a: (-a) % modulus,
        sum_=lambda a, b: (a + b) % modulus,
        product=lambda a, b: (a * b) % modulus,
        scaled=lambda a, k: (a * k) % modulus,
    )


def _collect_queries(expr: Expression) -> List[Query]:
    seen, out = set(), []

    def poly(q):
        if q not in seen:
            seen.add(q)
            out.append(q)

    expr.evaluate(
        constant=lambda c: None,
        poly=poly,
        challenge=lambda i: None,
        negated=lambda a: None,
        sum_=lambda a, b: None,
        product=lambda a, b: None,
        scaled=lambda a, k: None,
    )
    return out


def query_layout(expr, num_advice, num_lookup, selectors, fixed, nrow):
    """Slots of the queried columns, shared by both fold evaluators.

    Query indices cover selectors, fixed, then the W1 fold-variable range
    (the fold polynomial P(W1 + j*W2) only queries the first instance's
    variables).  Returns (qslot: Query -> ("s"|"a", slot), [(fold-var
    index, rot)] per advice slot, [pre-rotated int column] per static
    slot)."""
    n_sel, n_fix = len(selectors), len(fixed)
    max_width = num_advice + 5 * num_lookup
    qslot, advice_idx_rot, static_cols = {}, [], []
    for q in _collect_queries(expr):
        rot = q.rotation % nrow
        if q.index < n_sel + n_fix:
            qslot[q] = ("s", len(static_cols))
            if q.index < n_sel:
                col = [1 if b else 0 for b in selectors[q.index]]
            else:
                col = list(fixed[q.index - n_sel])
            if rot:
                col = col[rot:] + col[:rot]
            static_cols.append(col)
        else:
            idx = q.index - n_sel - n_fix
            if idx >= max_width:
                raise ValueError(
                    "fold evaluator only supports first-instance queries"
                )
            qslot[q] = ("a", len(advice_idx_rot))
            advice_idx_rot.append((idx, rot))
    return qslot, advice_idx_rot, static_cols


def point_challenges(j_values, ch1, ch2, scalars, modulus):
    """Per fold point j: the folded challenges ch1 + j*ch2 mod p, extended
    with the host-evaluated witness-free scalar subtrees."""
    rows = []
    for j in j_values:
        chj = [(a + j * b) % modulus for a, b in zip(ch1, ch2)]
        rows.append(chj + [_eval_scalar(s, modulus, chj) for s in scalars])
    return rows


def compile_ops(expr: Expression, qslot, modulus: int):
    """Expression -> (ops int32 (n,4), n_regs, consts (n_c, 4) u64).

    Rows are (op, a, b, dst); CSE by structural key; one SSA register per
    unique node; constants are Montgomery 4x64 limbs."""
    ops: List[tuple] = []
    consts: List[int] = []
    const_slot = {}
    memo = {}

    def const_of(v: int) -> int:
        v = v % modulus
        if v not in const_slot:
            const_slot[v] = len(consts)
            consts.append(v * _MONT_R % modulus)
        return const_slot[v]

    def emit(op, a, b=-1) -> int:
        dst = len(ops)
        ops.append((op, a, b, dst))
        return dst

    def go(e) -> int:
        if isinstance(e, Poly):
            key = ("q", e.query)
        elif isinstance(e, Challenge):
            key = ("c", e.index)
        elif isinstance(e, Const):
            key = ("k", e.value % modulus)
        else:
            a = go(e.a)
            if isinstance(e, Neg):
                key = ("n", a)
            elif isinstance(e, Scaled):
                key = ("s", a, e.k % modulus)
            else:
                b = go(e.b)
                lo, hi = min(a, b), max(a, b)
                key = (("+" if isinstance(e, Sum) else "*"), lo, hi)
        if key in memo:
            return memo[key]
        if key[0] == "q":
            kind, slot = qslot[e.query]
            r = emit(OP_LOAD_STATIC if kind == "s" else OP_LOAD_FOLD, slot)
        elif key[0] == "c":
            r = emit(OP_LOAD_CH, e.index)
        elif key[0] == "k":
            r = emit(OP_LOAD_CONST, const_of(e.value))
        elif key[0] == "n":
            r = emit(OP_NEG, key[1])
        elif key[0] == "s":
            kr = emit(OP_LOAD_CONST, const_of(e.k))
            r = emit(OP_MUL, key[1], kr)
        else:
            r = emit(OP_ADD if key[0] == "+" else OP_MUL, key[1], key[2])
        memo[key] = r
        return r

    out_reg = go(expr)
    ops.append((OP_OUTPUT, out_reg, -1, out_reg))
    n_regs = len(ops)
    op_arr = np.asarray(ops, dtype=np.int32)
    if consts:
        c64 = np.zeros((len(consts), 4), dtype=np.uint64)
        for i, v in enumerate(consts):
            for k in range(4):
                c64[i, k] = (v >> (64 * k)) & 0xFFFFFFFFFFFFFFFF
    else:
        c64 = np.zeros((1, 4), dtype=np.uint64)
    return op_arr, n_regs, c64


def register_program(ops, n_sq: int, n_aq: int, n_ch: int, n_c: int):
    """Map compile_ops' SSA list onto a register file.

    The file is [static columns | W1 fold columns | W2 fold columns | j |
    challenges | constants | -1 | temporaries | scratch].  The program
    opens with W1 + j*W2 for every fold column, written over W1's slot;
    then loads are slot numbers and only the arithmetic is left, as
    (is_mul, a, b, dst) rows.  Negation multiplies by the -1 slot.  A
    temporary is freed after its last use, so the file grows with the live
    values, not with the op count.  The program is padded to a multiple of
    64 rows (scratch += scratch) and the file to a multiple of 32
    registers, so that most gate polynomials share a compiled loop.
    Returns (prog (n_rows, 4) int32, output register, file size)."""
    base_w1, base_w2 = n_sq, n_sq + n_aq
    reg_j = base_w2 + n_aq
    base_c = reg_j + 1
    base_k = base_c + n_ch
    minus_one = base_k + n_c
    base_t = minus_one + 1
    prog = []
    for a in range(n_aq):
        prog.append((1, reg_j, base_w2 + a, base_w2 + a))
        prog.append((0, base_w1 + a, base_w2 + a, base_w1 + a))
    last_use = {}
    for i, (op, a, b, _dst) in enumerate(ops):
        if op in (OP_ADD, OP_MUL):
            last_use[a] = last_use[b] = i
        elif op == OP_NEG:
            last_use[a] = i
        elif op == OP_OUTPUT:
            last_use[a] = len(ops)
    reg, free = {}, []
    n_tmp = 0
    out_reg = None
    for i, (op, a, b, dst) in enumerate(ops):
        if op == OP_LOAD_STATIC:
            reg[dst] = a
        elif op == OP_LOAD_FOLD:
            reg[dst] = base_w1 + a
        elif op == OP_LOAD_CH:
            reg[dst] = base_c + a
        elif op == OP_LOAD_CONST:
            reg[dst] = base_k + a
        elif op == OP_OUTPUT:
            out_reg = reg[a]
        else:
            ra = reg[a]
            rb = minus_one if op == OP_NEG else reg[b]
            for s in {a} if op == OP_NEG else {a, b}:
                if last_use[s] == i and reg[s] >= base_t:
                    free.append(reg[s])
            if free:
                rd = free.pop()
            else:
                rd = base_t + n_tmp
                n_tmp += 1
            reg[dst] = rd
            prog.append((0 if op == OP_ADD else 1, ra, rb, rd))
    scratch = base_t + n_tmp
    n_pad = -len(prog) % 64 if prog else 64
    prog.extend([(0, scratch, scratch, scratch)] * n_pad)
    n_file = -(-(scratch + 1) // 32) * 32
    return np.asarray(prog, dtype=np.int32), out_reg, n_file


@partial(jax.jit, static_argnames=("n_file", "sharding"))
def _assemble(sq, w1, w2, jm, chj, cst, *, n_file, sharding):
    """The register file of one fold point: sq (n_sq, 16, nrow) static
    columns, w1/w2 (n_aq, 16, nrow) fold columns, then the scalars jm (16,)
    Montgomery j, chj (n_ch, 16) challenges at j and cst (n_c + 1, 16)
    constants, -1 last, broadcast over the rows; zero-padded to n_file."""
    nrow = sq.shape[-1]
    scal = jnp.concatenate([jm[None], chj, cst])
    regs = jnp.concatenate([
        sq, w1, w2, jnp.broadcast_to(scal[:, :, None], scal.shape + (nrow,))
    ])
    regs = jnp.concatenate([
        regs,
        jnp.zeros((n_file - regs.shape[0], NUM_LIMBS, nrow), jnp.uint32),
    ])
    if sharding is not None:
        regs = jax.lax.with_sharding_constraint(regs, sharding)
    return regs


@partial(jax.jit, static_argnames=("modulus", "sharding"))
def _run(prog, out_reg, regs, *, modulus, sharding):
    """Run `prog` over the register file; returns register out_reg."""
    tf = tfield(modulus)
    if sharding is not None:
        regs = jax.lax.with_sharding_constraint(regs, sharding)

    def step(i, regs):
        x = jax.lax.dynamic_index_in_dim(regs, prog[i, 1], keepdims=False)
        y = jax.lax.dynamic_index_in_dim(regs, prog[i, 2], keepdims=False)
        r = jnp.where(prog[i, 0] == 1, tf.mul(x, y), tf.add(x, y))
        return jax.lax.dynamic_update_index_in_dim(regs, r, prog[i, 3], 0)

    regs = jax.lax.fori_loop(0, prog.shape[0], step, regs)
    return jax.lax.dynamic_index_in_dim(regs, out_reg, keepdims=False)


class FoldEvaluator:
    """Multi-point fold evaluation of one expression over all rows, on the
    device (query layout: `query_layout`)."""

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
        self.lf = limb_field(modulus)
        self.nrow = nrow
        self.qslot, self.advice_idx_rot, static_cols = query_layout(
            expr, num_advice, num_lookup, selectors, fixed, nrow
        )
        self.n_sq = len(static_cols)
        # (n_sq, 16, nrow) Montgomery, pre-rotated, lanes = rows
        if static_cols:
            enc = self.lf.encode(
                [v for col in static_cols for v in col]
            ).reshape(len(static_cols), nrow, NUM_LIMBS)
            self.static_stack = jnp.swapaxes(enc, 1, 2)
        else:
            self.static_stack = jnp.zeros((0, NUM_LIMBS, nrow), jnp.uint32)
        self._stack_jit = jax.jit(self._stack_advice)
        self._prog_cache = {}
        self._static_on = {}

    def _program(self, n_ch_base: int):
        """(scalars, n_ch, prog, out_reg, file size, constants (n_c + 1,
        16)) for a challenge count (cached)."""
        if n_ch_base not in self._prog_cache:
            expr, scalars = _split_scalar_subtrees(self.expr, n_ch_base)
            ops, _, c64 = compile_ops(expr, self.qslot, self.modulus)
            n_ch = max(n_ch_base + len(scalars), 1)
            prog, out_reg, n_file = register_program(
                ops, self.n_sq, len(self.advice_idx_rot), n_ch, len(c64)
            )
            minus_one = self.lf.encode([self.modulus - 1])
            cst = jnp.concatenate(
                [jnp.asarray(limbs64_to_16(c64)), minus_one]
            )
            self._prog_cache[n_ch_base] = (
                scalars, n_ch, jnp.asarray(prog), out_reg, n_file, cst
            )
        return self._prog_cache[n_ch_base]

    # -- witness prep --------------------------------------------------------
    def _stack_advice(self, Ws):
        """Round vectors -> (n_aq, 16, nrow) stacked queried columns."""
        cols = []
        for idx, rot in self.advice_idx_rot:
            rnd, colj = advice_round_col(self.num_advice, idx, len(Ws))
            col = jax.lax.dynamic_slice_in_dim(
                Ws[rnd], colj * self.nrow, self.nrow, axis=0
            )
            if rot:
                col = jnp.roll(col, -rot, axis=0)
            cols.append(col.T)
        if not cols:
            return jnp.zeros((0, NUM_LIMBS, self.nrow), jnp.uint32)
        return jnp.stack(cols)

    def _static(self, sharding):
        if sharding is None:
            return self.static_stack
        if sharding not in self._static_on:
            self._static_on[sharding] = jax.device_put(
                self.static_stack, sharding
            )
        return self._static_on[sharding]

    # -- execution ----------------------------------------------------------
    def fold_eval_multi(self, W1s, W2s, j_values: Sequence[int],
                        ch1: Sequence[int], ch2: Sequence[int], mesh=None):
        """Evaluate P(W1 + j*W2) for every j in j_values.

        ch1/ch2: plain-int challenge vectors of the two instances (the
        challenge at fold point j is ch1 + j*ch2 mod p, matching
        nifs/vanilla.commit_cross_terms).  With a mesh the rows are sharded
        over it.  Returns (n_j, nrow, 16) Montgomery limb array.
        """
        p = self.modulus
        lf = self.lf
        n_j = len(j_values)
        scalars, n_ch, prog, out_reg, n_file, cst = self._program(len(ch1))
        sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            from ..parallel.mesh import AXIS

            sharding = NamedSharding(mesh, PartitionSpec(None, None, AXIS))

        w1 = self._stack_jit(tuple(W1s))
        w2 = self._stack_jit(tuple(W2s))
        jm = lf.encode([j % p for j in j_values])  # (n_j, 16)
        rows = point_challenges(j_values, ch1, ch2, scalars, p)
        if rows and rows[0]:
            ch = lf.encode([v for row in rows for v in row]).reshape(
                n_j, n_ch, NUM_LIMBS
            )
        else:
            ch = jnp.zeros((n_j, 1, NUM_LIMBS), jnp.uint32)
        sq = self._static(sharding)
        outs = []
        for i in range(n_j):
            regs = _assemble(sq, w1, w2, jm[i], ch[i], cst, n_file=n_file,
                             sharding=sharding)
            outs.append(_run(prog, out_reg, regs, modulus=p,
                             sharding=sharding))
        return jnp.swapaxes(jnp.stack(outs), 1, 2)  # (n_j, nrow, 16)
