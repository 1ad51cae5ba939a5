"""IVC accumulator checkpoint/resume.

The reference only persists the commitment-key cache
(/root/reference/src/commitment.rs:96-167); IVC state is never checkpointed,
so a crashed multi-hour fold restarts from step 0 (SURVEY.md §5 flags
accumulator checkpointing as a required addition for long folds).
`save(ivc, path)` / `load(ivc_like, path)` persist the full prover state —
both relaxed traces, the pending secondary trace, z values, and step —
as one .npz: instances as int arrays, witnesses as raw Montgomery uint32
limb arrays.  Loading restores into a freshly-constructed IVC (same
PublicParams/circuits), after which fold_step continues from the saved step.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np

from ..curves.host import AffinePoint, CurveParams, Fq2, G2Point, Tuple12
from ..fields.host import field
from ..plonk.structure import (
    PlonkInstance,
    PlonkTrace,
    PlonkWitness,
    RelaxedPlonkInstance,
    RelaxedPlonkTrace,
    RelaxedPlonkWitness,
)

_LIMB = (1 << 64) - 1


def _int_to_u64s(v: int, n: int = 4) -> List[int]:
    return [(v >> (64 * i)) & _LIMB for i in range(n)]


def _u64s_to_int(a) -> int:
    return sum(int(x) << (64 * i) for i, x in enumerate(a))


def _pts_arr(pts: List[AffinePoint]) -> np.ndarray:
    rows = []
    for p in pts:
        if p.is_inf:
            rows.append([0] * 8)
        else:
            rows.append(_int_to_u64s(p.x.v) + _int_to_u64s(p.y.v))
    return np.asarray(rows, dtype=np.uint64).reshape(-1, 8)


def _arr_pts(arr, curve: CurveParams) -> List[AffinePoint]:
    F = field(curve.base_modulus)
    out = []
    for row in arr:
        x, y = _u64s_to_int(row[:4]), _u64s_to_int(row[4:])
        if x == 0 and y == 0:
            out.append(AffinePoint.identity(curve))
        else:
            out.append(AffinePoint(curve, F(x), F(y)))
    return out


def _g2_arr(pts: List[G2Point]) -> np.ndarray:
    rows = []
    for p in pts:
        if p.is_inf:
            rows.append([0] * 16)
        else:
            rows.append(
                _int_to_u64s(p.x.c0.v) + _int_to_u64s(p.x.c1.v)
                + _int_to_u64s(p.y.c0.v) + _int_to_u64s(p.y.c1.v)
            )
    return np.asarray(rows, dtype=np.uint64).reshape(-1, 16)


def _arr_g2(arr, curve: CurveParams) -> List[G2Point]:
    F = field(curve.base_modulus)
    out = []
    for row in arr:
        vals = [_u64s_to_int(row[4 * i : 4 * i + 4]) for i in range(4)]
        if all(v == 0 for v in vals):
            out.append(G2Point.identity(F))
        else:
            out.append(
                G2Point(Fq2(F(vals[0]), F(vals[1])), Fq2(F(vals[2]), F(vals[3])))
            )
    return out


def _gt_arr(t: Tuple12) -> np.ndarray:
    return np.asarray(
        [_int_to_u64s(c.v) for c in t.elements], dtype=np.uint64
    )


def _arr_gt(arr, curve: CurveParams) -> Tuple12:
    F = field(curve.base_modulus)
    return Tuple12([F(_u64s_to_int(row)) for row in arr], F)


def _ints_arr(vals: List[int]) -> np.ndarray:
    return np.asarray([_int_to_u64s(v) for v in vals], dtype=np.uint64).reshape(
        -1, 4
    )


def _arr_ints(arr) -> List[int]:
    return [_u64s_to_int(row) for row in arr]


def _save_relaxed(d, prefix: str, tr: RelaxedPlonkTrace):
    U, W = tr.U, tr.W
    d[f"{prefix}_Wc"] = _pts_arr(U.W_commitments)
    d[f"{prefix}_E"] = _pts_arr([U.E_commitment])
    d[f"{prefix}_inst"] = _ints_arr(U.instance)
    d[f"{prefix}_chal"] = _ints_arr(U.challenges)
    d[f"{prefix}_u"] = _ints_arr([U.u])
    d[f"{prefix}_g1"] = _pts_arr(U.g1_elements)
    d[f"{prefix}_g2"] = _g2_arr(U.g2_elements)
    d[f"{prefix}_gt"] = _gt_arr(U.gt_element)
    for i, w in enumerate(W.W):
        d[f"{prefix}_W{i}"] = np.asarray(w)
    d[f"{prefix}_Wn"] = np.asarray([len(W.W)])
    d[f"{prefix}_Ew"] = np.asarray(W.E)


def _load_relaxed(z, prefix: str, curve: CurveParams, lf) -> RelaxedPlonkTrace:
    U = RelaxedPlonkInstance(
        curve=curve,
        W_commitments=_arr_pts(z[f"{prefix}_Wc"], curve),
        E_commitment=_arr_pts(z[f"{prefix}_E"], curve)[0],
        instance=_arr_ints(z[f"{prefix}_inst"]),
        challenges=_arr_ints(z[f"{prefix}_chal"]),
        u=_arr_ints(z[f"{prefix}_u"])[0],
        g1_elements=_arr_pts(z[f"{prefix}_g1"], curve),
        g2_elements=_arr_g2(z[f"{prefix}_g2"], curve),
        gt_element=_arr_gt(z[f"{prefix}_gt"], curve),
    )
    n = int(z[f"{prefix}_Wn"][0])
    W = RelaxedPlonkWitness(
        lf,
        [jnp.asarray(z[f"{prefix}_W{i}"]) for i in range(n)],
        jnp.asarray(z[f"{prefix}_Ew"]),
    )
    return RelaxedPlonkTrace(U, W)


def _save_plain(d, prefix: str, tr: PlonkTrace):
    u, w = tr.u, tr.w
    d[f"{prefix}_Wc"] = _pts_arr(u.W_commitments)
    d[f"{prefix}_inst"] = _ints_arr(u.instance)
    d[f"{prefix}_chal"] = _ints_arr(u.challenges)
    d[f"{prefix}_g1"] = _pts_arr(u.g1_elements)
    d[f"{prefix}_g2"] = _g2_arr(u.g2_elements)
    for i, wr in enumerate(w.W):
        d[f"{prefix}_W{i}"] = np.asarray(wr)
    d[f"{prefix}_Wn"] = np.asarray([len(w.W)])


def _load_plain(z, prefix: str, curve: CurveParams, lf) -> PlonkTrace:
    u = PlonkInstance(
        curve=curve,
        W_commitments=_arr_pts(z[f"{prefix}_Wc"], curve),
        instance=_arr_ints(z[f"{prefix}_inst"]),
        challenges=_arr_ints(z[f"{prefix}_chal"]),
        g1_elements=_arr_pts(z[f"{prefix}_g1"], curve),
        g2_elements=_arr_g2(z[f"{prefix}_g2"], curve),
    )
    n = int(z[f"{prefix}_Wn"][0])
    w = PlonkWitness(lf, [jnp.asarray(z[f"{prefix}_W{i}"]) for i in range(n)])
    return PlonkTrace(u, w)


def save(ivc, path: str):
    d = {}
    d["step"] = np.asarray([ivc.step])
    d["p_z0"] = _ints_arr(ivc.primary.z_0)
    d["p_zi"] = _ints_arr(ivc.primary.z_i)
    d["s_z0"] = _ints_arr(ivc.secondary.z_0)
    d["s_zi"] = _ints_arr(ivc.secondary.z_i)
    _save_relaxed(d, "pr", ivc.primary.relaxed_trace)
    _save_relaxed(d, "sr", ivc.secondary.relaxed_trace)
    _save_plain(d, "st", ivc.secondary_trace)
    np.savez_compressed(path, **d)


def load(ivc, path: str):
    """Restore state into an IVC built with the same PublicParams."""
    from ..fields.limbs import limb_field

    z = np.load(path)
    pp = ivc.pp
    p_lf = limb_field(pp.primary_curve.scalar_modulus)
    s_lf = limb_field(pp.secondary_curve.scalar_modulus)
    ivc.step = int(z["step"][0])
    ivc.primary.z_0 = _arr_ints(z["p_z0"])
    ivc.primary.z_i = _arr_ints(z["p_zi"])
    ivc.secondary.z_0 = _arr_ints(z["s_z0"])
    ivc.secondary.z_i = _arr_ints(z["s_zi"])
    ivc.primary.relaxed_trace = _load_relaxed(z, "pr", pp.primary_curve, p_lf)
    ivc.secondary.relaxed_trace = _load_relaxed(
        z, "sr", pp.secondary_curve, s_lf
    )
    ivc.secondary_trace = _load_plain(z, "st", pp.secondary_curve, s_lf)
    return ivc
