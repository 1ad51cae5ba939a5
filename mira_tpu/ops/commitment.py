"""Pedersen vector commitment key (reference /root/reference/src/commitment.rs).

Generator derivation follows the reference exactly in structure: a Shake256
XOF seeded with the label emits 32 uniform bytes per generator
(commitment.rs:58-66), each mapped through the RFC 9380 SVDW random-oracle
construction that halo2curves exposes as
`hash_to_curve("from_uniform_bytes")` (commitment.rs:67) — see
curves/svdw.py.  Setup runs through the threaded native generator
(native/keygen.cpp — the role rayon plays at commitment.rs:66), making
real binding keys at k>=20 take seconds instead of hours; the python
svdw path remains as the bit-parity oracle and no-toolchain fallback.
Set MIRA_HTC=xof for the round-1 SHA3 try-and-increment map (old caches).

The key is array-backed: (n, 2, 16)-limb raw affine coordinates, with
host AffinePoint objects materialized lazily for the host MSM.  Commitments
take the platform's MSM route (routes.py): the native host Pippenger on the
CPU, the device MSM on the GPU.  Keys are cached on disk as .npy (the
reference caches raw-memory dumps, commitment.rs:96-167).
"""

from __future__ import annotations

import hashlib
import jax.numpy as jnp
import os
from typing import List, Optional

import numpy as np

from ..curves.host import AffinePoint, CurveParams
from ..curves.jax_curve import jacobian_ops
from ..fields.host import field
from ..fields.limbs import NUM_LIMBS, ints_to_limbs, limb_field, limbs_to_ints
from ..routes import route
from ..utils.tracing import span
from .msm import encode_scalars, msm_device


def map_to_curve(curve: CurveParams, uniform_bytes: bytes) -> AffinePoint:
    """32 uniform bytes -> point, dispatching on MIRA_HTC (svdw default)."""
    if os.environ.get("MIRA_HTC", "svdw") == "svdw":
        from ..curves.svdw import hash_to_curve

        return hash_to_curve(curve, "from_uniform_bytes")(uniform_bytes)
    return _map_to_curve_xof(curve, uniform_bytes)


def _map_to_curve_xof(curve: CurveParams, uniform_bytes: bytes) -> AffinePoint:
    """Round-1 fallback: SHA3 try-and-increment, even root."""
    F = field(curve.base_modulus)
    x0 = int.from_bytes(
        hashlib.sha3_256(b"mira-tpu-htc" + uniform_bytes).digest(), "little"
    )
    ctr = 0
    while True:
        x = F(x0 + ctr)
        y2 = x * x * x + F(curve.b)
        y = y2.sqrt()
        if y is not None:
            if y.v % 2 == 1:
                y = -y
            return AffinePoint(curve, x, y)
        ctr += 1


def _validate_limbs_on_curve(curve: CurveParams, limbs: np.ndarray):
    """Raise if any (x, y) pair is off-curve. Native batch check when possible."""
    from .native_keygen import limbs16_to_u64x4, on_curve_check_native

    bad = on_curve_check_native(limbs16_to_u64x4(limbs), curve)
    if bad is not None:
        if bad:
            raise ValueError(f"corrupted commitment key cache: {bad} points off-curve")
        return
    F = field(curve.base_modulus)
    xs = limbs_to_ints(limbs[:, 0])
    ys = limbs_to_ints(limbs[:, 1])
    for x, y in zip(xs, ys):
        if not AffinePoint(curve, F(x), F(y)).is_on_curve():
            raise ValueError("corrupted commitment key cache")


class CommitmentKey:
    def __init__(self, curve: CurveParams, limbs: np.ndarray):
        """limbs: (n, 2, 16) uint32 raw (non-Montgomery) affine coordinates."""
        self.curve = curve
        self._limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
        self._points: Optional[List[AffinePoint]] = None
        self._enc_cache = None
        # tape id -> (C_template, gathered key points or None, npad)
        self._delta_cache = {}
        self._aux_dir: Optional[str] = None  # template-commitment disk home

    def __len__(self):
        return self._limbs.shape[0]

    @property
    def points(self) -> List[AffinePoint]:
        """Host AffinePoint list, materialized lazily (host MSM only)."""
        if self._points is None:
            F = field(self.curve.base_modulus)
            xs = limbs_to_ints(self._limbs[:, 0])
            ys = limbs_to_ints(self._limbs[:, 1])
            self._points = [
                AffinePoint(self.curve, F(x), F(y)) for x, y in zip(xs, ys)
            ]
        return self._points

    @property
    def _enc(self):
        """(X, Y, Z) Montgomery device limb arrays (Jacobian, Z=1)."""
        return self._enc_slice(len(self))

    def _enc_slice(self, n: int):
        """Montgomery device encoding of the FIRST n key points, growing the
        cached prefix on demand — large keys (SnarkStar ck 2^23-2^24) never
        hold device memory for points past the largest MSM width used."""
        cached_n = self._enc_cache[0].shape[0] if self._enc_cache else 0
        if n > cached_n:
            lf = limb_field(self.curve.base_modulus)
            X = lf.encode_raw16(self._limbs[:n, 0])
            Y = lf.encode_raw16(self._limbs[:n, 1])
            Z = jnp.broadcast_to(
                jnp.asarray(lf.one_mont_np, dtype=jnp.uint32), (n, NUM_LIMBS)
            )
            self._enc_cache = (X, Y, Z)
        if n == (self._enc_cache[0].shape[0]):
            return self._enc_cache
        return tuple(c[:n] for c in self._enc_cache)

    @classmethod
    def from_points(cls, curve: CurveParams, points: List[AffinePoint]):
        limbs = np.stack(
            [
                ints_to_limbs([p.x.v for p in points]),
                ints_to_limbs([p.y.v for p in points]),
            ],
            axis=1,
        )
        key = cls(curve, limbs)
        key._points = list(points)
        return key

    @classmethod
    def setup(cls, curve: CurveParams, k: int, label: bytes = b"") -> "CommitmentKey":
        n = 1 << k
        if os.environ.get("MIRA_HTC", "svdw") == "svdw":
            from .native_keygen import keygen_native, u64x4_to_limbs16

            xy = keygen_native(curve, n, label)
            if xy is not None:
                return cls(curve, u64x4_to_limbs16(xy))
        xof = hashlib.shake_256(label)
        stream = xof.digest(32 * n)
        points = [
            map_to_curve(curve, stream[32 * i : 32 * (i + 1)]) for i in range(n)
        ]
        return cls.from_points(curve, points)

    @classmethod
    def load_or_setup_cache(
        cls, curve: CurveParams, k: int, label: str, cache_dir: str = ".cache/ck"
    ) -> "CommitmentKey":
        htc = os.environ.get("MIRA_HTC", "svdw")
        # disk home for template commitments (commit_delta); the key digest
        # is appended on first use, so a stale or foreign key never matches
        aux_dir = os.path.join(
            os.path.dirname(os.path.normpath(cache_dir)), "ctmpl",
            curve.name, f"{label}-{htc}",
        )

        def _path(kk):
            return os.path.join(
                cache_dir, curve.name, label,
                f"{kk}-{htc}.npy" if htc != "xof" else f"{kk}.npy")

        path = _path(k)
        if os.path.exists(path):
            arr = np.load(path)  # (n, 2, 16) uint32 raw limbs
            _validate_limbs_on_curve(curve, arr)
            key = cls(curve, arr)
            key._aux_dir = aux_dir
            return key
        # The generator stream is prefix-stable (one XOF point per 32-byte
        # block, commitment.rs:52-76 semantics): a cached key of any k' > k
        # with the same label contains this key as its first 2^k rows —
        # memory-map the big file and copy only the slice.
        for k2 in range(k + 1, 33):
            big = _path(k2)
            if os.path.exists(big):
                arr = np.array(np.load(big, mmap_mode="r")[: 1 << k])
                _validate_limbs_on_curve(curve, arr)
                key = cls(curve, arr)
                key._aux_dir = aux_dir
                return key
        key = cls.setup(curve, k, label.encode())
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, key._limbs)
        key._aux_dir = aux_dir
        return key

    # -- commitment ----------------------------------------------------------
    def commit_ints(self, values: List[int]) -> AffinePoint:
        """Commit to raw scalar ints (host API)."""
        if len(values) > len(self):
            raise ValueError(
                f"input too long: {len(values)} > key size {len(self)}"
            )
        if route("msm") == "native":
            return self._commit_host(
                [v % self.curve.scalar_modulus for v in values],
                self.points[: len(values)],
            )
        sc = encode_scalars(values, self.curve.scalar_modulus)
        return self._decode(self._msm_device(sc))

    def commit_device(self, witness_mont, mesh=None) -> AffinePoint:
        """Commit to a device Montgomery limb vector (the hot path).

        The MSM takes the platform's route: the native host Pippenger on the
        CPU (native/msm.cpp), the device MSM on the GPU (ops/msm.py).

        With a mesh, points and scalars are sharded across the devices and
        the per-shard partial MSMs combine over the mesh (parallel/msm.py) —
        the multi-device analog of the reference's rayon'd best_multiexp
        (/root/reference/src/commitment.rs:78-87).
        """
        n = witness_mont.shape[0]
        if n > len(self):
            raise ValueError(f"input too long: {n} > key size {len(self)}")
        lf = limb_field(self.curve.scalar_modulus)
        if mesh is not None:
            from ..parallel.msm import sharded_msm

            ndev = mesh.devices.size
            scalars = lf.to_plain(witness_mont)
            n_pad = min(max(_pow2_at_least(n), ndev), len(self))
            if n_pad < n:
                n_pad = len(self)
            if n_pad > n:
                pad = np.zeros((n_pad - n, NUM_LIMBS), dtype=np.uint32)
                scalars = jnp.concatenate([scalars, jnp.asarray(pad)], axis=0)
            pts = self._enc_slice(n_pad)
            return self._decode(sharded_msm(scalars, pts, self.curve, mesh))
        if route("msm") == "native":
            return self._commit_host(lf.decode(witness_mont), self.points[:n])
        return self._decode(self._msm_device(lf.to_plain(witness_mont)))

    def commit_device_many(self, vectors, mesh=None, defer=False):
        """Commit a list of Montgomery vectors, decoding all results in one
        host sync instead of one per MSM.

        With defer=True, returns a zero-arg callable that performs the
        decode — the caller can do host work (e.g. the Gt pairing cross
        terms) while the dispatched MSMs run on the device."""
        import jax

        if mesh is not None or route("msm") == "native":
            pts = [self.commit_device(v, mesh=mesh) for v in vectors]
            return (lambda: pts) if defer else pts

        outs = []
        lf = limb_field(self.curve.scalar_modulus)
        with span("ct_msm_dispatch"):
            for v in vectors:
                n = v.shape[0]
                if n > len(self):
                    raise ValueError(
                        f"input too long: {n} > key size {len(self)}"
                    )
                outs.append(self._msm_device(lf.to_plain(v)))

        def _decode():
            with span("ct_decode"):
                # one batched device->host gather for every result
                flat = jax.device_get([c for out in outs for c in out])
                return [
                    self._decode(tuple(flat[3 * i + j] for j in range(3)))
                    for i in range(len(outs))
                ]

        return _decode if defer else _decode()

    def _decode(self, out) -> AffinePoint:
        """Jacobian Montgomery limb triple -> host affine point."""
        ops = jacobian_ops(self.curve.name)
        return ops.decode_points(tuple(c[None] for c in out))[0]

    def _commit_host(self, values, points) -> AffinePoint:
        from .native_msm import available, msm_native

        if available():  # C++ Pippenger (native/msm.cpp)
            return msm_native(values, points)
        from ..curves.host import msm_host_pippenger

        return msm_host_pippenger(values, points)

    def _msm_device(self, scalars, points=None):
        """Dispatch one device MSM over plain-limb scalars against the first
        key points (or `points`); returns the Jacobian limb triple WITHOUT
        decoding (async).  Widths pad to a power of two with zero scalars,
        so the compiled shapes stay log-many."""
        n = scalars.shape[0]
        if points is None:
            n_pad = min(_pow2_at_least(n), len(self))
            if n_pad < n:
                n_pad = len(self)
            points = self._enc_slice(n_pad)
        else:
            n_pad = points[0].shape[0]
        if n_pad > n:
            pad = np.zeros((n_pad - n, scalars.shape[1]), dtype=np.uint32)
            scalars = jnp.concatenate([scalars, jnp.asarray(pad)], axis=0)
        return msm_device(scalars, points, self.curve)

    def commit_delta(self, dw) -> AffinePoint:
        """Incremental commitment for a tape-replayed DeviceWitness
        (table/packed.py): the witness differs from its captured template
        only at the tape's write positions, so

            C(W) = C(template) + MSM(value - template_value @ positions).

        The per-step MSM runs over nwrites points (~250k for the k=17 SFC)
        instead of num_cols*2^k (~2M) — the positions are FIXED per tape, so
        the gathered, encoded key points are kept with the template
        commitment.  Replaces the reference's full best_multiexp per SPS
        round (/root/reference/src/plonk/mod.rs:653-907) in the IVC steady
        state."""
        lf = limb_field(self.curve.scalar_modulus)
        # CapturedSynthesis carries a process-unique uid (id() could be
        # reused after GC and alias a stale cache entry)
        token = getattr(dw.cache_token, "uid", None)
        if token is None:
            token = id(dw.cache_token)
        entry = self._delta_cache.get(token)
        if entry is None:
            entry = self._delta_entry(dw)
            self._delta_cache[token] = entry
        C_t, gpts, npad = entry
        if gpts is None:  # host route
            d_pt = self._commit_host(
                lf.decode(dw.delta_mont()),
                [self.points[int(i)] for i in dw.positions_np],
            )
            return C_t.add(d_pt)

        _sync = os.environ.get("MIRA_SYNC_SPANS") == "1"

        def fence(x):
            if _sync:
                import jax

                jax.block_until_ready(x)
            return x

        with span("delta_scalars"):
            delta = fence(lf.to_plain(dw.delta_mont()))
        with span("delta_msm"):
            out = fence(self._msm_device(delta, gpts))

        # LAZY decode: the MSM is dispatched here, but the host sync slides
        # to the first coordinate access — the next NIFS prove's transcript
        # absorption — by which time the cross-term evaluation and MSMs are
        # already queued behind it on the device.
        def _materialize(out=out, C_t=C_t):
            with span("delta_decode"):
                d_pt = self._decode(out)
            return C_t.add(d_pt)

        from ..curves.host import LazyAffinePoint

        return LazyAffinePoint(self.curve, _materialize)

    def _delta_entry(self, dw):
        """One-time per tape: the template commitment (persisted under a
        template-hash name, so later processes skip the full-width one-shot
        MSM) and, on a device route, the gathered key points."""
        C_t = None
        tag = getattr(dw.cache_token, "template_tag", None)
        ptmpl = getattr(dw.cache_token, "packed_template", None)
        if tag is None and ptmpl is not None:
            tag = hashlib.sha1(ptmpl.tobytes()).hexdigest()[:16]
            try:
                dw.cache_token.template_tag = tag
            except AttributeError:
                pass
        if tag is not None:
            cached = self._aux_load(f"ctmpl-{tag}.npy")
            if cached is not None:
                xv, yv, inf = limbs_to_ints(cached)
                F = field(self.curve.base_modulus)
                pt = (
                    AffinePoint.identity(self.curve) if inf
                    else AffinePoint(self.curve, F(xv), F(yv))
                )
                if pt.is_on_curve():
                    C_t = pt
        if C_t is None:
            C_t = self.commit_device(dw.template_mont)
            if tag is not None:
                self._aux_save(
                    f"ctmpl-{tag}.npy",
                    ints_to_limbs(
                        [0 if C_t.is_inf else C_t.x.v,
                         0 if C_t.is_inf else C_t.y.v,
                         int(C_t.is_inf)]
                    ),
                )
        if route("msm") == "native":
            return C_t, None, 0
        pos = dw.positions_np
        npos = _pow2_at_least(len(pos))
        npad = npos - len(pos)
        # pad with repeats of position 0; their scalars are always zero
        idx = np.concatenate([pos, np.zeros(npad, dtype=pos.dtype)])
        sub = self._limbs[idx]
        lfq = limb_field(self.curve.base_modulus)
        gpts = (
            lfq.encode_raw16(sub[:, 0]),
            lfq.encode_raw16(sub[:, 1]),
            jnp.broadcast_to(
                jnp.asarray(lfq.one_mont_np, dtype=jnp.uint32),
                (npos, NUM_LIMBS),
            ),
        )
        return C_t, gpts, npad

    # -- template-commitment persistence ----------------------------------
    # A template commitment is deterministic per (key, template): it is kept
    # next to the key cache under .cache/ctmpl/<curve>/<label>-<htc>/<key
    # digest>/ and loads in milliseconds where the MSM took seconds.
    def _aux_path(self, name: str) -> Optional[str]:
        if self._aux_dir is None:
            return None
        digest = getattr(self, "_key_digest", None)
        if digest is None:
            digest = hashlib.sha1(self._limbs.tobytes()).hexdigest()[:12]
            self._key_digest = digest
        return os.path.join(self._aux_dir, digest, name)

    def _aux_load(self, name: str):
        p = self._aux_path(name)
        if p is None or not os.path.exists(p):
            return None
        try:
            return np.load(p)
        except (OSError, ValueError):
            return None

    def _aux_save(self, name: str, arr):
        p = self._aux_path(name)
        if p is None:
            return
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            tmp = p + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, np.asarray(arr))
            os.replace(tmp, p)
        except OSError:  # disk full: the cache is only an optimization
            pass

    def release_device_cache(self):
        """Free the device-resident key encoding and delta-commit points
        (between the folding phase and the decider); both rebuild lazily."""
        self._enc_cache = None
        self._delta_cache = {}


def _pow2_at_least(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)
