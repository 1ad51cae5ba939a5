"""Radix-2 NTT over limb-decomposed field arrays.

Vectorized formulation of the reference FFT (/root/reference/src/fft.rs):
instead of the reference's recursive rayon butterflies, each of the log2(n)
stages is one fused vectorized butterfly over the whole array — rotations and
pairings are static reshapes, twiddles are a precomputed Montgomery-form
table, so XLA sees log2(n) large elementwise kernels (no data-dependent
control flow).

Semantics (bit-reversal, twiddle order, ifft divisor, coset zeta powers)
mirror /root/reference/src/fft.rs:51-226; the known-answer vector at
fft.rs:239-258 is enforced in tests/test_ntt.py.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.limbs import NUM_LIMBS, limb_field
from ..fields.params import field_params
from ..routes import route


def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def get_omega(modulus: int, log_n: int, inverse: bool = False) -> int:
    """omega for domain size 2^log_n (reference fft.rs:12-23: square
    ROOT_OF_UNITY down from 2-adicity S)."""
    params = field_params(modulus)
    assert log_n <= params.s, f"domain 2^{log_n} exceeds 2-adicity {params.s}"
    w = params.root_of_unity_inv if inverse else params.root_of_unity
    for _ in range(log_n, params.s):
        w = (w * w) % modulus
    return w


@lru_cache(maxsize=None)
def _twiddle_table(modulus: int, log_n: int, inverse: bool):
    """Full Montgomery twiddle vector w^0..w^(n/2-1)
    (as in reference fft.rs:75-81) plus the bit-reversal permutation."""
    lf = limb_field(modulus)
    n = 1 << log_n
    w = get_omega(modulus, log_n, inverse)
    tw = [1] * max(n // 2, 1)
    for i in range(1, n // 2):
        tw[i] = (tw[i - 1] * w) % modulus
    perm = jnp.asarray(_bitrev_perm(log_n))
    return lf.encode(tw), perm


@lru_cache(maxsize=None)
def _ntt_jit(modulus: int, log_n: int, inverse: bool):
    """One jitted program per size.  Stages are RESHAPE butterflies — a
    (n/2h, 2, h) view with a strided-slice twiddle row — rather than iota
    gathers, so no stage needs a data-dependent gather.  The graph is log_n
    unrolled stages; each is one fused CIOS mul + adds."""
    lf = limb_field(modulus)
    n = 1 << log_n
    tw_table, perm = _twiddle_table(modulus, log_n, inverse)

    def run(a):
        a = a[perm]
        for s in range(log_n):
            half = 1 << s
            step = n // (2 * half)
            x = a.reshape(n // (2 * half), 2, half, NUM_LIMBS)
            u, v = x[:, 0], x[:, 1]
            tw = jax.lax.slice_in_dim(tw_table, 0, n // 2, stride=step)
            prod = lf.mul(v, tw[None])
            a = jnp.concatenate(
                [lf.add(u, prod), lf.add(u, lf.neg(prod))], axis=1
            ).reshape(n, NUM_LIMBS)
        if inverse:
            divisor = pow(n, -1, modulus)
            a = lf.mul(a, lf.const(divisor, (1,)))
        return a

    return jax.jit(run)


def ntt(a, modulus: int, inverse: bool = False):
    """Forward/inverse NTT of a (n, NUM_LIMBS) Montgomery limb array.

    Output is in standard order; inverse includes the 1/n divisor
    (reference fft.rs:160-174).  Runs the XLA reshape stages on every
    platform (the "ntt" route of routes.py).
    """
    n = a.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if log_n == 0:
        return a
    if route("ntt") != "xla":  # pragma: no cover - the only NTT route
        raise ValueError("unknown NTT route")
    return _ntt_jit(modulus, log_n, inverse)(a)


@lru_cache(maxsize=None)
def _coset_powers(modulus: int, n: int, into: bool):
    """[1, z, z^2, 1, z, z^2, ...] (or inverse order) in Montgomery form,
    mirroring distribute_powers_zeta (reference fft.rs:205-226)."""
    lf = limb_field(modulus)
    params = field_params(modulus)
    z = params.zeta
    z2 = (z * z) % modulus
    first, second = (z, z2) if into else (z2, z)
    vals = [[1, first, second][i % 3] for i in range(n)]
    return lf.encode(vals)


def coset_ntt(a, modulus: int):
    """Evaluate coefficients on the coset zeta*H (reference coset_fft)."""
    n = a.shape[0]
    lf = limb_field(modulus)
    a = lf.mul(a, _coset_powers(modulus, n, True))
    return ntt(a, modulus)


def coset_intt(a, modulus: int):
    """Values on zeta*H -> coefficients (reference coset_ifft)."""
    n = a.shape[0]
    lf = limb_field(modulus)
    a = ntt(a, modulus, inverse=True)
    return lf.mul(a, _coset_powers(modulus, n, False))


# ---------------------------------------------------------------------------
# Host (python-int) reference for tests and tiny protocol-side polynomials
# ---------------------------------------------------------------------------


def ntt_host(vals, modulus: int, inverse: bool = False):
    n = len(vals)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    w = get_omega(modulus, log_n, inverse)
    perm = _bitrev_perm(log_n)
    a = [vals[p] for p in perm]
    half_tw = [1] * max(n // 2, 1)
    for i in range(1, n // 2):
        half_tw[i] = (half_tw[i - 1] * w) % modulus
    for s in range(log_n):
        half = 1 << s
        step = n // (2 * half)
        for base in range(0, n, 2 * half):
            for k in range(half):
                t = (a[base + half + k] * half_tw[k * step]) % modulus
                a[base + half + k] = (a[base + k] - t) % modulus
                a[base + k] = (a[base + k] + t) % modulus
    if inverse:
        ninv = pow(n, -1, modulus)
        a = [(x * ninv) % modulus for x in a]
    return a
