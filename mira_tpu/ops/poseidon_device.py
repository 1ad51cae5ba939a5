"""Batched Poseidon on device — §2.3 item 4 of SURVEY.md.

The transcript sponge is inherently sequential (host: ops/poseidon.py), but
batch hashing — Merkle levels, leaf commitments, witness preparation — is
embarrassingly parallel: N independent states ride the vector lanes while
the optimized-constant schedule (start / sparse-partial / end, identical to
the host permutation and therefore to the reference
/root/reference/src/poseidon/poseidon_hash.rs:174-254) runs as `lax.scan`s
over stacked round constants, so the compiled graph contains only a handful
of CIOS instances regardless of round counts.

Field elements are LimbField Montgomery (N, 16) uint32 arrays; constants are
Montgomery-encoded once per Spec.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from ..fields.limbs import limb_field
from .poseidon import get_spec


def _tree_sum(vals, lf):
    """Sum over axis 0 of (K, ..., 16) by halving (log-many add instances)."""
    while vals.shape[0] > 1:
        k = vals.shape[0]
        half = k // 2
        merged = lf.add(vals[:half], vals[half : 2 * half])
        vals = (
            jnp.concatenate([merged, vals[2 * half :]], axis=0)
            if k % 2
            else merged
        )
    return vals[0]


@lru_cache(maxsize=None)
def _hash_batch_jit(modulus: int, t: int, rate: int, r_f: int, r_p: int,
                    num_inputs: int):
    """Batched fixed-length sponge hash: (N, num_inputs, 16) Montgomery
    inputs -> (N, 16) Montgomery output (state[1], untruncated)."""
    spec = get_spec(modulus, t, rate, r_f, r_p)
    lf = limb_field(modulus)
    half = r_f // 2

    def enc_rows(rows):  # list of rows of host field elems -> (R, t, 16)
        flat = [c.v for row in rows for c in row]
        return jnp.asarray(lf.encode(flat)).reshape(len(rows), -1, 16)

    c_start = enc_rows(spec.constants_start)  # (half+1, t, 16)
    c_partial = jnp.asarray(
        lf.encode([c.v for c in spec.constants_partial])
    )  # (r_p, 16)
    c_end = enc_rows(spec.constants_end)  # (half-1, t, 16)
    mds = enc_rows(spec.mds)  # (t, t, 16)
    pre_sparse = enc_rows(spec.pre_sparse_mds)  # (t, t, 16)
    sp_rows = enc_rows([m.row for m in spec.sparse_matrices])  # (r_p, t, 16)
    sp_cols = enc_rows(
        [m.col_hat for m in spec.sparse_matrices]
    )  # (r_p, t-1, 16)
    iv = jnp.asarray(lf.encode([1 << 64]))[0]
    one_enc = jnp.asarray(lf.encode([1]))[0]

    def pow5(x):
        s = lf.mul(x, x)
        return lf.mul(lf.mul(s, s), x)

    def mat_vec(m, state):
        # m: (t, t, 16); state: (t, N, 16) -> (t, N, 16)
        prod = lf.mul(m[:, :, None, :], state[None, :, :, :])  # (t, t, N, 16)
        return _tree_sum(jnp.swapaxes(prod, 0, 1), lf)

    def full_round(state, consts):  # consts: (t, 16)
        s = lf.add(pow5(state), consts[:, None, :])
        return mat_vec(mds, s), None

    def partial_round(state, xs):
        const, row, col = xs  # (16,), (t,16), (t-1,16)
        s0 = lf.add(pow5(state[0]), const[None, :])
        state = jnp.concatenate([s0[None], state[1:]], axis=0)
        new0 = _tree_sum(lf.mul(row[:, None, :], state), lf)
        rest = lf.add(lf.mul(col[:, None, :], state[0][None]), state[1:])
        return jnp.concatenate([new0[None], rest], axis=0), None

    def permutation(state, inputs):
        """state: (t, N, 16); inputs: (k, N, 16) with k < t."""
        n = state.shape[1]
        pre = c_start[0]  # (t, 16)
        k = inputs.shape[0]
        state = lf.add(state, jnp.broadcast_to(pre[:, None, :], state.shape))
        if k:
            state = jnp.concatenate(
                [state[:1], lf.add(state[1 : 1 + k], inputs), state[1 + k :]],
                axis=0,
            )
        if 1 + k < t:  # `1` pad marker in the first unused slot
            padded = lf.add(state[1 + k], jnp.broadcast_to(one_enc, (n, 16)))
            state = jnp.concatenate(
                [state[: 1 + k], padded[None], state[2 + k :]], axis=0
            )

        state, _ = jax.lax.scan(full_round, state, c_start[1:half])
        s = lf.add(pow5(state), c_start[half][:, None, :])
        state = mat_vec(pre_sparse, s)
        state, _ = jax.lax.scan(
            partial_round, state, (c_partial, sp_rows, sp_cols)
        )
        state, _ = jax.lax.scan(full_round, state, c_end)
        state = mat_vec(mds, pow5(state))
        return state

    def run(inputs):  # (N, num_inputs, 16)
        n = inputs.shape[0]
        state = jnp.concatenate(
            [
                jnp.broadcast_to(iv, (1, n, 16)),
                jnp.zeros((t - 1, n, 16), jnp.uint32),
            ],
            axis=0,
        )
        xs = jnp.swapaxes(inputs, 0, 1)  # (num_inputs, N, 16)
        for i in range(0, num_inputs, rate):
            state = permutation(state, xs[i : i + rate])
        if num_inputs % rate == 0:
            state = permutation(state, xs[:0])
        return state[1]

    return jax.jit(run)


def poseidon_hash_batch(values, modulus: int, t: int = 3, rate: int = 2,
                        r_f: int = 10, r_p: int = 10):
    """values: (N, L, 16) Montgomery limb array.  Returns (N, 16) Montgomery
    state[1] outputs — the same field elements the host sponge produces
    before bit truncation."""
    return _hash_batch_jit(modulus, t, rate, r_f, r_p, int(values.shape[1]))(
        values
    )
