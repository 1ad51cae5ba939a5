"""TensorStar: zkml program-counter folding — Mira's pairing-based zkml
accumulation workload (reference /root/reference/examples/zkml/).

The primary step circuit is a program-counter update over the Merkle tree
(zkml/circuit.rs `ProgramCounterUpdateCircuit` — identical chip stack to the
merkle workload, but driven by DETERMINISTIC updates derived from the model
inputs instead of random leaves; zkml/main.rs:104-138 converts the ark-field
inputs and indexes them as (batch_idx*len*2 + proof_idx*2 + j)).  The
SECONDARY side carries the zkml pairing instance shape:
num_g1=23, num_g2=2, gt_degree=3, gt_cross_terms=12 (zkml/main.rs:183-190),
so the primary step-folding circuit exercises Mira's fold_g1/fold_g2/fold_gt
at the zkml proof dimensions.

As with SnarkStar, the reference's SPS fills the g1/g2/gt element slots with
random placeholders ("TODO(jbeal)"); real proof ingestion is a recorded gap
on both sides.
"""

from __future__ import annotations

import time


def table_sizes(matrix_dim: int):
    """(k1, k2) ladder (zkml/main.rs:41-57); 0 = the no-pairing baseline."""
    if matrix_dim == 0:
        return (23, 23)
    if matrix_dim in (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        return (22, 22)
    raise ValueError(f"invalid matrix dim {matrix_dim}")


def ck_sizes(matrix_dim: int):
    """(ck1, ck2) ladder (zkml/main.rs:60-77)."""
    if matrix_dim == 0:
        return (27, 26)
    if matrix_dim in (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        return (26, 25)
    raise ValueError(f"invalid matrix dim {matrix_dim}")


def program_counter_updates(repeat_count: int, inputs, modulus: int):
    """zkml/main.rs:104-138: (repeat_count+1) batches of the converted model
    inputs, flattened with indices batch*len*2 + proof*2 + j."""
    n = len(inputs)
    return [
        [((i * n + j) % (1 << 31), inputs[j] % modulus) for j in range(n)]
        for i in range(repeat_count + 1)
    ]


def run(repeat_count: int = 1, matrix_dim: int = 32, baseline: bool = False,
        use_mock_ck: bool = True, k_override: int | None = None,
        debug_mode: bool = False):
    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ivc.ivc import IVC
    from ..ivc.public_params import CircuitSide, PublicParams
    from ..ivc.step_circuit import TrivialCircuit
    from ..ops.commitment import CommitmentKey
    from ..ops.mock_commitment import MockCommitmentKey
    from .merkle import MerkleTreeUpdateCircuit

    size_param = 0 if baseline else matrix_dim
    k1, k2 = (k_override, k_override) if k_override else table_sizes(size_param)
    ckk1, ckk2 = (k1 + 4, k2 + 4) if k_override else ck_sizes(size_param)

    p_mod = BN254_G1.scalar_modulus
    # model inputs: [1, 1] (zkml/main.rs:128 — Fr::one() x2, ark->ff identity)
    updates = program_counter_updates(repeat_count, [1, 1], p_mod)

    sc1 = MerkleTreeUpdateCircuit(p_mod, batch_size=1)
    for batch in updates:
        sc1.update_leaves(batch)
    sc2 = TrivialCircuit(arity=1)

    if use_mock_ck:
        ck1 = MockCommitmentKey(BN254_G1, k1 + 4, b"bn256")
        ck2 = MockCommitmentKey(GRUMPKIN, k2 + 4, b"grumpkin")
    else:
        ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, ckk1, "bn256")
        ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, ckk2, "grumpkin")

    t0 = time.time()
    pp = PublicParams(
        CircuitSide(sc1, ck1, k1),
        CircuitSide(
            sc2, ck2, k2,
            num_g1=23,
            num_g2=2,
            gt_degree=3,
            gt_cross_terms=12,
        ) if not baseline else CircuitSide(sc2, ck2, k2),
        BN254_G1,
        GRUMPKIN,
    )
    print(f"public params: {time.time() - t0:.1f}s")

    def _hbm(tag):
        """Log device memory occupancy (footprint evidence for k=22)."""
        try:
            import jax

            st = jax.local_devices()[0].memory_stats() or {}
            used = st.get("bytes_in_use", 0) >> 20
            lim = st.get("bytes_limit", 0) >> 20
            print(f"hbm[{tag}]: {used} MiB in use / {lim} MiB limit",
                  flush=True)
        except Exception:
            pass

    z0 = [sc1.front_proof_batch()[0].root().old]
    t0 = time.time()
    ivc = IVC(pp, sc1, z0, sc2, [0], debug_mode=debug_mode)
    print(f"ivc zero step: {time.time() - t0:.1f}s", flush=True)
    _hbm("post-zero-step")
    step_secs = []
    for step in range(repeat_count):
        sc1.pop_front_proof_batch()
        t0 = time.time()
        ivc.fold_step()
        step_secs.append(time.time() - t0)
        print(f"fold step {step + 1}: {step_secs[-1]:.1f}s", flush=True)
        _hbm(f"post-step-{step + 1}")
    if not use_mock_ck:
        for ck in (ck1, ck2):
            release = getattr(ck, "release_device_cache", None)
            if release:
                release()
    ivc.verify(strict=True)
    print(f"TensorStar: {repeat_count} steps (matrix_dim {matrix_dim}"
          f"{', baseline' if baseline else ''}) verified OK")
    return step_secs


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat-count", type=int, default=1)
    ap.add_argument("--matrix-dim", type=int, default=32)
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--real-ck", action="store_true")
    ap.add_argument("--debug-mode", action="store_true")
    args = ap.parse_args()
    run(args.repeat_count, args.matrix_dim, args.baseline, not args.real_ck,
        args.k, args.debug_mode)
