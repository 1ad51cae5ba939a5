"""External proof ingestion (snarkjs JSON).

Role parity: /root/reference/examples/groth16/conversion.rs (ark->halo2);
here the interchange dialect is snarkjs JSON over bn128.
"""

import copy
import json
import os
import random

import pytest

from mira_tpu.snark.conversion import (
    load_proof_bundle,
    proof_from_json,
    proof_to_json,
    save_proof_bundle,
    vk_from_json,
    vk_to_json,
)
from mira_tpu.snark.groth16 import GtAccumulator, benchmark_r1cs, prove, setup, verify

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "groth16_bundle.json")


@pytest.fixture(scope="module")
def bundle():
    rng = random.Random(42)
    r1cs, z = benchmark_r1cs(8)
    pk = setup(r1cs, rng)
    pub = z[1:r1cs.num_public + 1]
    items = [(prove(pk, r1cs, z, rng), list(pub)) for _ in range(2)]
    return pk.vk, items


def test_proof_json_roundtrip(bundle):
    vk, items = bundle
    pf, pub = items[0]
    obj = json.loads(json.dumps(proof_to_json(pf)))
    back = proof_from_json(obj)
    assert back.a == pf.a and back.c == pf.c
    assert back.b.x == pf.b.x and back.b.y == pf.b.y
    vk2 = vk_from_json(json.loads(json.dumps(vk_to_json(vk))))
    assert verify(vk2, back, pub)


def test_bundle_file_roundtrip_and_fold(tmp_path, bundle):
    vk, items = bundle
    path = str(tmp_path / "bundle.json")
    save_proof_bundle(path, vk, items)
    vk2, items2 = load_proof_bundle(path)
    for (pf, pub) in items2:
        assert verify(vk2, pf, pub)
    # fold the ingested proofs with real Gt cross terms and pairing-check
    acc = GtAccumulator(vk2)
    rng = random.Random(1)
    for pf, pub in items2:
        acc.fold(pf, pub, rng.randrange(1 << 127))
    assert acc.check()


def test_tampered_points_rejected(bundle):
    vk, items = bundle
    pf, _pub = items[0]
    bad = proof_to_json(pf)
    bad["pi_a"][0] = str(int(bad["pi_a"][0]) + 1)
    with pytest.raises(ValueError, match="on curve"):
        proof_from_json(bad)
    bad2 = proof_to_json(pf)
    bad2["pi_b"][0][0] = str(int(bad2["pi_b"][0][0]) + 1)
    with pytest.raises(ValueError, match="twist"):
        proof_from_json(bad2)


def test_checked_in_fixture_folds():
    """The committed fixture file is the external-prover stand-in (this
    image has no arkworks/snarkjs to generate one independently; any
    snarkjs `proof.json`/`verification_key.json` maps 1:1 onto this
    bundle format)."""
    vk, items = load_proof_bundle(FIXTURE)
    for pf, pub in items:
        assert verify(vk, pf, pub)
    acc = GtAccumulator(vk)
    acc.fold(items[0][0], items[0][1], 0xABCDEF)
    assert acc.check()
