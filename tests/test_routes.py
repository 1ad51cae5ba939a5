"""The route table (mira_tpu/routes.py): one implementation per operation
and platform, an error for anything else."""

import pytest

from mira_tpu import routes

EXPECTED = {
    ("msm", "cpu"): "native",
    ("msm", "gpu"): "cuda",
    ("fold_eval", "cpu"): "native",
    ("fold_eval", "gpu"): "jnp",
    ("ntt", "cpu"): "xla",
    ("ntt", "gpu"): "xla",
    ("sponge", "cpu"): "xla",
    ("sponge", "gpu"): "xla",
    ("encode", "cpu"): "native",
    ("encode", "gpu"): "device",
    ("witness", "cpu"): "packed",
    ("witness", "gpu"): "device",
}


@pytest.mark.parametrize("op,platform", sorted(EXPECTED))
def test_route_per_op_and_platform(op, platform):
    assert routes.route(op, platform) == EXPECTED[(op, platform)]
    assert routes.route(op, platform) in routes.IMPLS[op]


def test_table_covers_every_op():
    assert set(routes.ROUTES) == {op for op, _ in EXPECTED}
    assert routes.table("gpu") == {
        op: impl for (op, plat), impl in EXPECTED.items() if plat == "gpu"
    }


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no route"):
        routes.route("msm", platform)


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown operation"):
        routes.route("fft", "cpu")


def test_default_platform_is_jax_backend():
    import jax

    assert routes.platform() == jax.default_backend()
    assert routes.route("msm") == routes.route("msm", jax.default_backend())


def test_forced_route_is_scoped():
    before = routes.route("msm", "cpu")
    with routes.forced("msm", "xla"):
        assert routes.route("msm", "cpu") == "xla"
        assert routes.route("msm", "gpu") == "xla"
    assert routes.route("msm", "cpu") == before
    with pytest.raises(ValueError):
        with routes.forced("msm", "pallas"):
            pass
