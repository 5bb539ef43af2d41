"""The no-JAX check compares whole top-level module names."""

from slambench import nojax


def test_port_passes():
    assert nojax.loaded_banned(["mageslam_tpu_torch",
                                "mageslam_tpu_torch.ops.fast"]) == []


def test_jax_package_fails():
    assert nojax.loaded_banned(["mageslam_tpu.ops"]) == ["mageslam_tpu"]
    assert nojax.loaded_banned(["jax", "jaxlib.xla_client", "flax"]) == \
        ["flax", "jax", "jaxlib"]


def test_prefixes_are_not_names():
    assert nojax.loaded_banned(["jaxtyping", "mageslam_tpu_torchx"]) == []
