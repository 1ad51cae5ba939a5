"""Packed witness: advice columns as a raw 16-bit-limb numpy plane instead
of python-int lists.

The witness-tape replay (ivc/tape_runner.py) produces cell values as packed
words straight from the native VM; keeping them packed all the way into the
Montgomery encode (fields/limbs.py encode_raw16) removes the two big
host-side conversions of the SPS hot path — int->limb encode
(ints_to_limbs' per-int to_bytes) and the VM-output->int scatter.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..fields.limbs import NUM_LIMBS, limbs_to_ints


class PackedWitness:
    """Advice table as one (num_cols * nrow, 16) uint32 plain-limb array
    (row-major per column, zero-padded to nrow — the layout
    encode_padded produces).

    `used_rows` bounds the nonzero extent of every column: rows beyond it
    are zero, and zero is its own Montgomery form, so the encode only has
    to convert the used prefixes (most tables are short circuits in tall
    2^k tables)."""

    __slots__ = ("raw16", "num_cols", "nrow", "used_rows")

    def __init__(
        self, raw16: np.ndarray, num_cols: int, nrow: int, used_rows: int = -1
    ):
        assert raw16.shape == (num_cols * nrow, NUM_LIMBS)
        self.raw16 = raw16
        self.num_cols = num_cols
        self.nrow = nrow
        self.used_rows = nrow if used_rows < 0 else min(used_rows, nrow)

    def encode_mont(self, lf):
        """Montgomery device encode of the whole table, converting only the
        used prefix of each column."""
        import jax.numpy as jnp

        used = self.used_rows
        if used >= self.nrow:
            return lf.encode_raw16(self.raw16)
        view = self.raw16.reshape(self.num_cols, self.nrow, NUM_LIMBS)
        enc = lf.encode_raw16(
            np.ascontiguousarray(view[:, :used]).reshape(-1, NUM_LIMBS)
        )
        out = np.zeros_like(self.raw16)
        out_v = out.reshape(self.num_cols, self.nrow, NUM_LIMBS)
        out_v[:, :used] = np.asarray(enc).reshape(
            self.num_cols, used, NUM_LIMBS
        )
        return jnp.asarray(out)

    def __len__(self):  # len(witness) == number of advice columns
        return self.num_cols

    def to_int_cols(self) -> List[List[int]]:
        """Fallback for consumers that need python-int columns (lookup
        coefficient evaluation)."""
        flat = limbs_to_ints(self.raw16)
        return [
            flat[c * self.nrow : (c + 1) * self.nrow]
            for c in range(self.num_cols)
        ]


class DeviceWitness:
    """Witness held device-resident end-to-end (accelerator tape-replay path).

    Per step, only the dynamic cell values cross the host->device boundary
    ((nwrites, 16) plain limbs); the static template lives on device in
    Montgomery form, built once per captured tape.  This removes the
    per-step device->host->device round trip of PackedWitness.encode_mont
    and enables DELTA commitments: because the witness differs from
    the template only at the write positions, C(W) = C(template) +
    MSM(vals - template_vals @ positions) — an MSM over nwrites points
    instead of num_cols*2^k (CommitmentKey.commit_delta).
    """

    __slots__ = (
        "lf",  # LimbField of the witness scalar field
        "cache_token",  # CapturedSynthesis identity (per-tape cache key)
        "template_mont",  # (num_cols*nrow, 16) Montgomery, device
        "template_vals_mont",  # (nwrites, 16) Montgomery @ positions, device
        "positions",  # (nwrites,) int32 flat positions, device
        "positions_np",  # same, host numpy (key-point gather)
        "vals16",  # (nwrites, 16) uint32 plain limbs, host (this step)
        "num_cols",
        "nrow",
        "_vals_mont",
        "_full",
    )

    def __init__(self, lf, cache_token, template_mont, template_vals_mont,
                 positions, positions_np, vals16, num_cols, nrow):
        self.lf = lf
        self.cache_token = cache_token
        self.template_mont = template_mont
        self.template_vals_mont = template_vals_mont
        self.positions = positions
        self.positions_np = positions_np
        self.vals16 = vals16
        self.num_cols = num_cols
        self.nrow = nrow
        self._vals_mont = None
        self._full = None

    def __len__(self):
        return self.num_cols

    @property
    def vals_mont(self):
        """(nwrites, 16) Montgomery device array of this step's values."""
        if self._vals_mont is None:
            import jax.numpy as jnp

            from ..utils.tracing import span

            with span("vals_to_mont"):
                self._vals_mont = self.lf.from_plain(jnp.asarray(self.vals16))
                if __import__("os").environ.get("MIRA_SYNC_SPANS") == "1":
                    import jax

                    jax.block_until_ready(self._vals_mont)
        return self._vals_mont

    def delta_mont(self):
        """(nwrites, 16) Montgomery (value - template_value) at positions."""
        return self.lf.sub(self.vals_mont, self.template_vals_mont)

    def encode_mont(self, lf) -> "jnp.ndarray":
        """Full concatenated-column Montgomery layout (num_cols*nrow, 16):
        one device scatter into the cached template, no host round trip.
        Positions are pre-sorted and unique (tape_runner dedups and sorts at
        capture), letting XLA lower a vectorized scatter instead of the
        serialized general case."""
        if self._full is None:
            from ..utils.tracing import span

            with span("witness_scatter"):
                self._full = self.template_mont.at[self.positions].set(
                    self.vals_mont,
                    indices_are_sorted=True,
                    unique_indices=True,
                )
                if __import__("os").environ.get("MIRA_SYNC_SPANS") == "1":
                    import jax

                    jax.block_until_ready(self._full)
        return self._full

    def to_int_cols(self) -> List[List[int]]:
        """Host-int fallback (lookup coefficient rounds)."""
        flat = self.lf.decode(self.encode_mont(self.lf))
        return [
            flat[c * self.nrow : (c + 1) * self.nrow]
            for c in range(self.num_cols)
        ]


def _last_nonzero(col: List[int]) -> int:
    """Index-after of the last nonzero entry, scanning coarse chunks with
    C-speed any() first (tall sparse tables: 2^22 rows, ~1% used)."""
    last = len(col)
    chunk = 4096
    while last > 0:
        lo = max(0, last - chunk)
        if any(col[lo:last]):
            for i in range(last - 1, lo - 1, -1):
                if col[i]:
                    return i + 1
        last = lo
    return 0


def pack_int_cols(cols: List[List[int]], nrow: int) -> PackedWitness:
    """Python-int columns -> PackedWitness (one-time, at tape capture);
    only the nonzero prefixes are converted."""
    from ..fields.limbs import ints_to_limbs

    raw = np.zeros((len(cols) * nrow, NUM_LIMBS), dtype=np.uint32)
    for c, col in enumerate(cols):
        last = _last_nonzero(col)
        if last:
            raw[c * nrow : c * nrow + last] = ints_to_limbs(col[:last])
    return PackedWitness(raw, len(cols), nrow)
