"""Vectorized prime-field arithmetic on 16-bit limb planes.

Design (see SURVEY.md §7): a field element is 16 little-endian 16-bit limbs
stored in a uint32 array of shape ``(..., 16)``; elements are kept in
Montgomery form (R = 2^256) on device.  All kernels are branch-free,
shape-static and jit/vmap/shard_map friendly:

* 16x16-bit partial products fit exactly in uint32 (no 64-bit products);
* multiplication is CIOS Montgomery with lazy per-column accumulation — the
  column magnitude stays < 2^23 so carries are deferred to one final ripple;
* comparisons/selects are mask arithmetic, never data-dependent control flow.

This replaces the reference's 64-bit-limb Rust field arithmetic (halo2curves,
consumed via e.g. /root/reference/src/commitment.rs:78-87 and the row-parallel
gate evaluation /root/reference/src/plonk/mod.rs:461-530) with a layout that
vectorizes over every element of an array.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..routes import route

LIMB_BITS = 16
NUM_LIMBS = 16
MASK = (1 << LIMB_BITS) - 1


def _native_encode_min() -> int:
    """Batch size above which Montgomery encodes on the native encode route
    (routes.py; the CPU) run on the native 4x64 kernel instead of XLA:CPU.
    MIRA_NATIVE_ENCODE_MIN=1 forces native for everything — the multichip
    dryrun uses it to avoid one-off XLA:CPU compiles for host-side
    reference values."""
    import os

    return int(os.environ.get("MIRA_NATIVE_ENCODE_MIN", "4096"))


def int_to_limbs(v: int) -> np.ndarray:
    return np.array(
        [(v >> (LIMB_BITS * i)) & MASK for i in range(NUM_LIMBS)], dtype=np.uint32
    )


def ints_to_limbs(vals) -> np.ndarray:
    """Python ints -> (n, 16) uint32 limb array (via fast byte packing)."""
    buf = b"".join(
        [(v if isinstance(v, int) else v.v).to_bytes(32, "little") for v in vals]
    )
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(vals), NUM_LIMBS)
    return u16.astype(np.uint32)


def limbs_to_int(arr) -> int:
    arr = np.asarray(arr, dtype=np.uint64)
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(NUM_LIMBS))


def limbs_to_ints(arr) -> list:
    """(n, 16) limb array -> python ints (via fast byte unpacking)."""
    flat = np.asarray(arr).reshape(-1, NUM_LIMBS).astype("<u2")
    buf = flat.tobytes()
    return [
        int.from_bytes(buf[32 * i : 32 * (i + 1)], "little") for i in range(len(flat))
    ]


def _shift_up(x, d, fill):
    """Shift d positions toward higher limbs along the last axis."""
    pad = [(0, 0)] * (x.ndim - 1) + [(d, 0)]
    return jnp.pad(x, pad, constant_values=fill)[..., : x.shape[-1]]


def _prefix_carry(g, p):
    """Carry INTO each limb from per-limb (generate, propagate) bools:
    c_0 = 0, c_{i+1} = g_i | (p_i & c_i) — Kogge-Stone parallel prefix,
    log2(K) whole-array steps instead of a K-deep sliced ripple (the sliced
    form made XLA:CPU compile time of every field add/sub pathological)."""
    k = g.shape[-1]
    G, P = g, p
    d = 1
    while d < k:
        G = G | (P & _shift_up(G, d, False))
        P = P & _shift_up(P, d, True)
        d *= 2
    return _shift_up(G, 1, False)


def _normalize(acc):
    """Ripple deferred carries so every limb is < 2^16.

    acc: (..., K) uint32 columns with values < 2^31; returns same K columns
    (the caller guarantees the top column absorbs the final carry).

    Vectorized: one peel pass splits each column into lo + carry (< 2^15),
    after which per-limb carries are 0/1 and one exact parallel-prefix pass
    finishes the ripple.
    """
    lo = acc & MASK
    hi = acc >> LIMB_BITS  # < 2^15
    shifted = _shift_up(hi, 1, 0)
    # top column stays unmasked — it absorbs the final carry
    t = jnp.concatenate(
        [lo[..., :-1] + shifted[..., :-1], acc[..., -1:] + shifted[..., -1:]],
        axis=-1,
    )
    g = (t >> LIMB_BITS) > 0  # 0/1 for non-top columns (t < 2^16 + 2^15)
    p = (t & MASK) == MASK
    c = _prefix_carry(g, p).astype(jnp.uint32)
    out = t + c
    return jnp.concatenate([out[..., :-1] & MASK, out[..., -1:]], axis=-1)


def _geq(a, b):
    """a >= b lexicographically over little-endian limbs; (...,) bool."""
    ne = a != b
    gt = a > b
    # number of differing limbs at index >= i; the most significant
    # differing limb (no differing limbs above it) decides
    s = jnp.cumsum(ne[..., ::-1], axis=-1)[..., ::-1]
    above = s - ne  # differing limbs strictly above i
    decided = (gt & (above == 0)).any(axis=-1)
    return decided | (s[..., 0] == 0)  # all-equal -> True


def _sub_limbs(a, b):
    """(a - b) over limbs, assuming a >= b. uint32 in, uint32 out.
    b limbs must be < 2^16; a's top column may exceed 2^16 (it has no
    higher limb to borrow from, and the result is masked anyway)."""
    t = a + jnp.uint32(MASK + 1) - b  # >= 1
    g = (t >> LIMB_BITS) == 0  # borrows regardless of incoming borrow
    p = t == (MASK + 1)  # borrows iff incoming borrow
    c = _prefix_carry(g, p).astype(jnp.uint32)
    return (t - c) & MASK


class LimbField:
    """Vectorized Montgomery arithmetic for one prime modulus.

    All device methods operate on uint32 arrays of shape (..., 16) and keep
    values in Montgomery form unless stated otherwise.
    """

    def __init__(self, modulus: int):
        assert modulus.bit_length() <= 255
        self.modulus = modulus
        self.p_np = int_to_limbs(modulus)
        r = 1 << (LIMB_BITS * NUM_LIMBS)
        self.r_mod_p = r % modulus
        self.r2_np = int_to_limbs((r * r) % modulus)
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) & MASK
        self.one_plain_np = int_to_limbs(1)
        self.one_mont_np = int_to_limbs(self.r_mod_p)
        # jit the hot kernels once per field instance (they unroll to many
        # small uint32 ops; eager dispatch would dominate otherwise)
        self.add = jax.jit(self.add)
        self.sub = jax.jit(self.sub)
        self.neg = jax.jit(self.neg)
        self.mul = jax.jit(self.mul)
        self.square = jax.jit(self.square)
        self.double = jax.jit(self.double)
        self.inv = jax.jit(self.inv)
        self.pow_int = jax.jit(self.pow_int, static_argnums=1)

    # -- host <-> device boundaries ----------------------------------------
    def encode(self, vals) -> jnp.ndarray:
        """Python ints / host field elements -> Montgomery limb array.

        The to-Montgomery multiply runs on device (one fused CIOS by R^2)
        instead of one Python bigint mul+mod per value — the host loop was
        dominant host cost on SnarkStar witness vectors.  On the native
        encode route the multiply runs on the native 4x64 kernel
        (fields/native64.py) instead of the XLA:CPU 16-bit-limb CIOS."""
        m = self.modulus
        vals = [v if isinstance(v, int) else v.v for v in vals]
        raw16 = ints_to_limbs([v if 0 <= v < m else v % m for v in vals])
        if raw16.shape[0] == 0:
            return jnp.asarray(raw16, dtype=jnp.uint32)
        if len(vals) >= _native_encode_min():
            if route("encode") == "native":
                try:
                    from .native64 import (
                        available,
                        limbs16_to_64,
                        limbs64_to_16,
                        to_mont,
                    )

                    if available():
                        return jnp.asarray(
                            limbs64_to_16(to_mont(m, limbs16_to_64(raw16)))
                        )
                except ImportError:  # pragma: no cover
                    pass
        raw = jnp.asarray(raw16, dtype=jnp.uint32)
        return self.mul(raw, jnp.asarray(self.r2_np, dtype=jnp.uint32)[None])

    def encode_raw16(self, raw16: np.ndarray) -> jnp.ndarray:
        """(n, 16) plain uint32 limb planes (values < p) -> Montgomery device
        array.  The packed twin of encode(): skips the python-int round trip
        entirely (used by the witness-tape replay, ivc/tape_runner.py)."""
        if raw16.shape[0] == 0:
            return jnp.asarray(raw16, dtype=jnp.uint32)
        m = self.modulus
        if raw16.shape[0] >= _native_encode_min():
            if route("encode") == "native":
                try:
                    from .native64 import available, to_mont16

                    if available():
                        # fused pack/mul/unpack pass — no 16<->64 temporaries
                        return jnp.asarray(to_mont16(m, raw16))
                except ImportError:  # pragma: no cover
                    pass
        raw = jnp.asarray(raw16, dtype=jnp.uint32)
        return self.mul(raw, jnp.asarray(self.r2_np, dtype=jnp.uint32)[None])

    def encode_padded(self, cols, nrow: int) -> jnp.ndarray:
        """Ragged columns -> concatenated (len(cols)*nrow, 16) Montgomery
        array with zero tails.  Only the nonzero prefixes are converted
        (Montgomery zero is zero), so sparse tables (large k, short
        circuits) skip both the padding and zero tails entirely."""
        from ..table.packed import _last_nonzero

        total = len(cols) * nrow
        lasts = [_last_nonzero(c) for c in cols]
        used = [v for c, last in zip(cols, lasts) for v in c[:last]]
        out = np.zeros((total, NUM_LIMBS), dtype=np.uint32)
        if used:
            enc = np.asarray(self.encode(used))
            off = 0
            for i, (c, last) in enumerate(zip(cols, lasts)):
                out[i * nrow : i * nrow + last] = enc[off : off + last]
                off += last
        return jnp.asarray(out)

    def decode(self, arr) -> list:
        """Montgomery limb array -> Python ints (canonical).

        From-Montgomery = one device CIOS by plain 1 (vR * 1 * R^-1 = v);
        on the native encode route large batches run on the native 4x64
        kernel."""
        arr = jnp.asarray(arr).reshape(-1, NUM_LIMBS)
        if arr.shape[0] == 0:
            return []
        if arr.shape[0] >= _native_encode_min():
            if route("encode") == "native":
                try:
                    from .native64 import available, from_mont16

                    if available():
                        return limbs_to_ints(
                            from_mont16(self.modulus, np.asarray(arr))
                        )
                except ImportError:  # pragma: no cover
                    pass
        raw = self.mul(arr, jnp.asarray(self.one_plain_np, dtype=jnp.uint32)[None])
        return limbs_to_ints(np.asarray(raw))

    # -- constants on device -------------------------------------------------
    def zero(self, shape=()) -> jnp.ndarray:
        return jnp.zeros((*shape, NUM_LIMBS), dtype=jnp.uint32)

    def one(self, shape=()) -> jnp.ndarray:
        return jnp.broadcast_to(
            jnp.asarray(self.one_mont_np, dtype=jnp.uint32), (*shape, NUM_LIMBS)
        )

    def const(self, v: int, shape=()) -> jnp.ndarray:
        """Plain int -> broadcast Montgomery-form constant."""
        r = 1 << (LIMB_BITS * NUM_LIMBS)
        limbs = jnp.asarray(int_to_limbs((v * r) % self.modulus), dtype=jnp.uint32)
        return jnp.broadcast_to(limbs, (*shape, NUM_LIMBS))

    # -- ring ops ------------------------------------------------------------
    def add(self, a, b):
        acc = a.astype(jnp.uint32) + b
        # one extra column for the potential carry out of limb 15
        acc = jnp.concatenate(
            [acc, jnp.zeros((*acc.shape[:-1], 1), jnp.uint32)], axis=-1
        )
        acc = _normalize(acc)
        return self._cond_sub_p(acc)

    def neg(self, a):
        p = jnp.asarray(self.p_np, dtype=jnp.uint32)
        is_zero = self.is_zero(a)
        d = _sub_limbs(jnp.broadcast_to(p, a.shape), a)
        return jnp.where(is_zero[..., None], a, d)

    def sub(self, a, b):
        return self.add(a, self.neg(b))

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """CIOS Montgomery multiplication: mont(a) * mont(b) -> mont(a*b).

        Lazy per-column accumulation: columns stay < 2^23 across all 16
        rounds, so carries ripple only once at the end.
        """
        p = jnp.asarray(self.p_np, dtype=jnp.uint32)
        shape = jnp.broadcast_shapes(a.shape, b.shape)
        a = jnp.broadcast_to(a, shape)
        b = jnp.broadcast_to(b, shape)
        zero_col = jnp.zeros((*shape[:-1], 1), jnp.uint32)

        def round_(i, acc):
            ai = jax.lax.dynamic_index_in_dim(a, i, axis=a.ndim - 1, keepdims=True)
            prod = ai * b  # exact 32-bit products of 16-bit limbs
            acc = acc.at[..., :NUM_LIMBS].add(prod & MASK)
            acc = acc.at[..., 1:].add(prod >> LIMB_BITS)
            m = (acc[..., 0] * self.n0inv) & MASK
            q = m[..., None] * p
            acc = acc.at[..., :NUM_LIMBS].add(q & MASK)
            acc = acc.at[..., 1:].add(q >> LIMB_BITS)
            carry = acc[..., 0] >> LIMB_BITS  # acc[...,0] ≡ 0 mod 2^16 now
            acc = jnp.concatenate([acc[..., 1:], zero_col], axis=-1)
            return acc.at[..., 0].add(carry)

        acc = jnp.zeros((*shape[:-1], NUM_LIMBS + 1), jnp.uint32)
        acc = jax.lax.fori_loop(0, NUM_LIMBS, round_, acc, unroll=2)
        acc = _normalize(acc)  # 17 columns, value < 2p
        return self._cond_sub_p(acc)

    def square(self, a):
        return self.mul(a, a)

    def _cond_sub_p(self, acc17):
        """acc17: (...,17) normalized limbs with value < 2p (< 2^256 + p).
        Subtract p at most twice; return canonical 16 limbs."""
        p17 = jnp.concatenate(
            [jnp.asarray(self.p_np, jnp.uint32), jnp.zeros(1, jnp.uint32)]
        )
        p17 = jnp.broadcast_to(p17, acc17.shape)
        for _ in range(2):
            ge = _geq(acc17, p17)
            sub = _sub_limbs(acc17, p17)
            acc17 = jnp.where(ge[..., None], sub, acc17)
        return acc17[..., :NUM_LIMBS]

    # -- derived ops ---------------------------------------------------------
    def pow_int(self, a, e: int):
        """a^e for a static Python-int exponent.

        Implemented as a lax.scan over the exponent bits (LSB first) so the
        compiled graph stays small (2 muls) regardless of exponent size.
        """
        if e == 0:
            return self.one(a.shape[:-1])
        nbits = e.bit_length()
        bits = jnp.asarray(
            np.array([(e >> i) & 1 for i in range(nbits)], dtype=np.uint32)
        )

        def body(carry, bit):
            result, base = carry
            mul_res = self.mul(result, base)
            result = jnp.where(bit > 0, mul_res, result)
            base = self.mul(base, base)
            return (result, base), None

        (result, _), _ = jax.lax.scan(body, (self.one(a.shape[:-1]), a), bits)
        return result

    def inv(self, a):
        """Batch inversion via Fermat (maps 0 -> 0, matching invert_or_zero)."""
        return self.pow_int(a, self.modulus - 2)

    def to_plain(self, a):
        """Montgomery form -> plain limbs (for MSM scalar digits)."""
        one = jnp.asarray(self.one_plain_np, dtype=jnp.uint32)
        return self.mul(a, jnp.broadcast_to(one, a.shape))

    def from_plain(self, a):
        """Plain limbs -> Montgomery form."""
        r2 = jnp.asarray(self.r2_np, dtype=jnp.uint32)
        return self.mul(a, jnp.broadcast_to(r2, a.shape))

    def is_zero(self, a):
        return jnp.all(a == 0, axis=-1)

    def eq(self, a, b):
        return jnp.all(a == b, axis=-1)

    def select(self, mask, a, b):
        """mask ? a : b  (mask shape (...,), operands (...,16))."""
        return jnp.where(mask[..., None], a, b)

    def sum(self, a, axis=0):
        """Field sum along an axis via halving tree of field adds (exact)."""
        a = jnp.moveaxis(a, axis, 0)
        while a.shape[0] > 1:
            n = a.shape[0]
            half = n // 2
            lo = self.add(a[:half], a[half : 2 * half])
            if n % 2:
                lo = lo.at[0].set(self.add(lo[0], a[-1]))
            a = lo
        return a[0]


@lru_cache(maxsize=None)
def limb_field(modulus: int) -> LimbField:
    return LimbField(modulus)
