"""NTT known-answer vector (reference /root/reference/src/fft.rs:239-258)
and roundtrip/coset properties."""

import random

import pytest

from mira_tpu.fields.limbs import limb_field
from mira_tpu.fields.params import BN254_FR
from mira_tpu.ops.ntt import coset_intt, coset_ntt, ntt, ntt_host

LF = limb_field(BN254_FR)

REFERENCE_FFT_VECTOR = [
    "28",
    "68918385373930674424918168212551896122229959265833979749191472831399925654",
    "17631683881184975370165255887551781615748388533673675138856",
    "68918385373930639161550405842601155791718184162270748252414405484049647934",
    "21888242871839275222246405745257275088548364400416034343698204186575808495613",
    "21819324486465344583084855339414673932756646216253763595445789781091758847675",
    "21888242871839275204614721864072299718383108512864252727949815652902133356753",
    "21819324486465344547821487577044723192426134441150200363949012713744408569955",
]


def test_fft_known_answer_device():
    a = LF.encode(list(range(8)))
    out = LF.decode(ntt(a, BN254_FR))
    assert out == [int(s) for s in REFERENCE_FFT_VECTOR]


def test_fft_known_answer_host():
    out = ntt_host(list(range(8)), BN254_FR)
    assert out == [int(s) for s in REFERENCE_FFT_VECTOR]


@pytest.mark.parametrize("k", [4, 6, 8])
def test_fft_roundtrip(k):
    rng = random.Random(k)
    vals = [rng.randrange(BN254_FR) for _ in range(1 << k)]
    a = LF.encode(vals)
    back = LF.decode(ntt(ntt(a, BN254_FR), BN254_FR, inverse=True))
    assert back == vals


def test_host_device_agree():
    rng = random.Random(99)
    vals = [rng.randrange(BN254_FR) for _ in range(32)]
    dev = LF.decode(ntt(LF.encode(vals), BN254_FR))
    host = ntt_host(vals, BN254_FR)
    assert dev == host


def test_coset_roundtrip():
    rng = random.Random(5)
    vals = [rng.randrange(BN254_FR) for _ in range(16)]
    a = LF.encode(vals)
    back = LF.decode(coset_intt(coset_ntt(a, BN254_FR), BN254_FR))
    assert back == vals


def test_coset_differs_from_plain():
    vals = list(range(16))
    a = LF.encode(vals)
    plain = LF.decode(ntt(a, BN254_FR))
    coset = LF.decode(coset_ntt(a, BN254_FR))
    assert plain != coset


def test_fft_evaluates_polynomial():
    # fft output[i] = poly(omega^i)
    from mira_tpu.ops.ntt import get_omega

    rng = random.Random(2)
    coeffs = [rng.randrange(BN254_FR) for _ in range(8)]
    out = ntt_host(coeffs, BN254_FR)
    w = get_omega(BN254_FR, 3)
    for i in range(8):
        x = pow(w, i, BN254_FR)
        want = sum(c * pow(x, j, BN254_FR) for j, c in enumerate(coeffs)) % BN254_FR
        assert out[i] == want


@pytest.mark.parametrize("log_n", [5, 7])
def test_inverse_matches_host(log_n):
    rng = random.Random(log_n)
    vals = [rng.randrange(BN254_FR) for _ in range(1 << log_n)]
    dev = LF.decode(ntt(LF.encode(vals), BN254_FR, inverse=True))
    assert dev == ntt_host(vals, BN254_FR, inverse=True)
