"""SnarkStar: Groth16-verifier folding — Mira's flagship pairing-based
accumulation workload (reference /root/reference/examples/groth16/).

The primary step circuit applies Merkle-tree updates (groth16 circuit.rs:120-164
uses the same MerkleTreeUpdateChip).  In structural mode the SECONDARY side's
instances carry the pairing data — per proof batch: num_g1 = 2*batch,
num_g2 = 1*batch, gt_degree = 2, gt_cross_terms = 2*batch
(groth16/main.rs:258-267) — so the PRIMARY step-folding circuit runs the
in-circuit G2 scalar-muls and Fp12 arithmetic of Mira's
fold_g1/fold_g2/fold_gt, exactly like the reference.  In REAL-proof mode the
pairing data rides the PRIMARY (bn254) side instead: BN254 points/Gt live
over Fq, which is the bn254 base field and the SECONDARY SFC's table field —
the reference's secondary-side placement only works because its elements are
random placeholders already in Fr.

NOTE: the reference's SPS currently fills g1/g2 instance elements and Gt cross
terms with *random placeholders* ("TODO(jbeal)", plonk/mod.rs:690-703,
vanilla/mod.rs:130-134); structural mode (default) exercises the fold
machinery on the same shapes.  `real_proofs=True` goes beyond the reference:
it generates Groth16 proofs on our own pairing stack (snark/groth16.py),
feeds real [A, C, vk_x]/[B] group elements into the SPS instances, folds true
bilinear Gt cross terms, and pairing-checks the folded Gt in the decider.
"""

from __future__ import annotations

import random
import time


def table_sizes(batch_size: int):
    """(k1, k2) ladder (groth16/main.rs:47-61)."""
    ladder = {0: (21, 21), 1: (19, 19), 2: (20, 20), 4: (21, 21),
              8: (22, 22), 16: (23, 23), 32: (24, 24)}
    return ladder[batch_size]


def ck_sizes(batch_size: int):
    """(ck1, ck2) ladder (groth16/main.rs:63-77)."""
    ladder = {0: (25, 24), 1: (23, 24), 2: (24, 24), 4: (25, 24),
              8: (26, 25), 16: (27, 26), 32: (28, 27)}
    return ladder[batch_size]


def run(steps: int = 1, batch_size: int = 1, use_mock_ck: bool = True,
        k_override: int | None = None, debug_mode: bool = False,
        real_proofs: bool = False, num_constraints: int = 1000,
        proof_file: str | None = None):
    from ..curves.host import BN254_G1, GRUMPKIN
    from ..ivc.ivc import IVC
    from ..ivc.public_params import CircuitSide, PublicParams
    from ..ivc.step_circuit import TrivialCircuit
    from ..ops.commitment import CommitmentKey
    from ..ops.mock_commitment import MockCommitmentKey
    from .merkle import MerkleTreeUpdateCircuit

    k1, k2 = (k_override, k_override) if k_override else table_sizes(batch_size)
    ckk1, ckk2 = (k1 + 4, k2 + 4) if k_override else ck_sizes(batch_size)

    rng = random.Random(0)
    p_mod = BN254_G1.scalar_modulus
    sc1 = MerkleTreeUpdateCircuit(p_mod, batch_size=1)
    for _ in range(steps + 2):
        sc1.random_update_leaves(rng)
    sc2 = TrivialCircuit(arity=1)

    if use_mock_ck:
        ck1 = MockCommitmentKey(BN254_G1, k1 + 4, b"bn256")
        ck2 = MockCommitmentKey(GRUMPKIN, k2 + 4, b"grumpkin")
    else:
        ck1 = CommitmentKey.load_or_setup_cache(BN254_G1, ckk1, "bn256")
        ck2 = CommitmentKey.load_or_setup_cache(GRUMPKIN, ckk2, "grumpkin")

    ctx = None
    if proof_file is not None:
        # EXTERNAL proofs: ingest a snarkjs-format bundle (vk + proofs)
        # through the conversion layer (snark/conversion.py — role of the
        # reference's examples/groth16/conversion.rs) and fold those.
        from ..snark.conversion import load_proof_bundle
        from ..snark.groth16 import Groth16FoldContext, verify

        t0 = time.time()
        vk, items = load_proof_bundle(proof_file)
        for pf, pub in items:
            assert verify(vk, pf, pub), "ingested proof fails verification"
        need = (steps + 2) * batch_size
        if len(items) < need:  # cycle the bundle to fill the fold schedule
            items = [items[i % len(items)] for i in range(need)]
        ctx = Groth16FoldContext(vk, batch_size)
        ctx.push_proofs(items)
        real_proofs = True
        print(f"ingested {len(items)} external proofs from {proof_file}: "
              f"{time.time() - t0:.1f}s")
    elif real_proofs:
        # REAL mode (beyond the reference, which discards its arkworks
        # proofs and folds random elements): generate Groth16 proofs on our
        # own stack and fold them with true pairing cross terms.
        from ..snark.groth16 import (
            Groth16FoldContext, benchmark_r1cs, prove, setup, verify,
        )

        t0 = time.time()
        r1cs, z = benchmark_r1cs(num_constraints)
        pk = setup(r1cs, rng)
        pub = z[1:r1cs.num_public + 1]
        proofs = []
        # zero step + the trailing secondary trace of every fold step each
        # consume one batch
        for _ in range((steps + 2) * batch_size):
            pf = prove(pk, r1cs, z, rng)
            proofs.append((pf, list(pub)))
        assert verify(pk.vk, proofs[0][0], pub)
        ctx = Groth16FoldContext(pk.vk, batch_size)
        ctx.push_proofs(proofs)
        print(f"groth16 setup+{len(proofs)} proofs: {time.time() - t0:.1f}s")

    t0 = time.time()
    if ctx is not None:
        # REAL mode: the pairing data must ride the PRIMARY (bn254) side —
        # BN254 proof points have Fq coordinates and Gt lives over Fq12, and
        # only the bn254 instances (base field Fq) fold them consistently
        # both off-circuit and in the secondary SFC (table over Fq).  The
        # reference parks its RANDOM placeholders on the secondary side
        # (groth16/main.rs:258-267), where real Fq values would be silently
        # reduced mod Fr.
        pp = PublicParams(
            CircuitSide(
                sc1, ck1, k1,
                num_g1=ctx.num_g1, num_g2=ctx.num_g2,
                gt_degree=2, gt_cross_terms=ctx.num_gt_cross_terms,
                groth16_ctx=ctx,
            ),
            CircuitSide(sc2, ck2, k2),
            BN254_G1,
            GRUMPKIN,
        )
    else:
        pp = PublicParams(
            CircuitSide(sc1, ck1, k1),
            CircuitSide(
                sc2, ck2, k2,
                num_g1=2 * batch_size,
                num_g2=1 * batch_size,
                gt_degree=2,
                gt_cross_terms=2 * batch_size,
            ),
            BN254_G1,
            GRUMPKIN,
        )
    print(f"public params: {time.time() - t0:.1f}s")

    z0 = [sc1.front_proof_batch()[0].root().old]
    t0 = time.time()
    ivc = IVC(pp, sc1, z0, sc2, [0], debug_mode=debug_mode)
    print(f"ivc zero step: {time.time() - t0:.1f}s")
    step_secs = []
    for step in range(steps):
        sc1.pop_front_proof_batch()
        t0 = time.time()
        ivc.fold_step()
        step_secs.append(time.time() - t0)
        print(f"fold step {step + 1}: {step_secs[-1]:.1f}s", flush=True)
    if not use_mock_ck:
        # the decider recomputes full-width commitments; free the
        # folding-phase device caches first
        for ck in (ck1, ck2):
            release = getattr(ck, "release_device_cache", None)
            if release:
                release()
    ivc.verify(strict=True)
    mode = "REAL Groth16 proofs + true Gt cross terms" if real_proofs else "structural"
    print(f"SnarkStar: {steps} steps x batch {batch_size} verified OK ({mode})")
    return step_secs


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--real-ck", action="store_true")
    ap.add_argument("--debug-mode", action="store_true")
    ap.add_argument("--real-proofs", action="store_true",
                    help="fold actual Groth16 proofs with real Gt cross terms")
    ap.add_argument("--num-constraints", type=int, default=1000)
    ap.add_argument("--proof-file", type=str, default=None,
                    help="snarkjs-format JSON bundle of external proofs to fold")
    args = ap.parse_args()
    run(args.steps, args.batch_size, not args.real_ck, args.k, args.debug_mode,
        args.real_proofs, args.num_constraints, args.proof_file)
