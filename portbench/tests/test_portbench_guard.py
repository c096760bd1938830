"""The import guard compares whole top-level names."""
import pytest

from portbench.guard import forbidden_modules


@pytest.mark.parametrize("names, bad", [
    (["repro_torch", "repro_torch.core.graph", "numpy"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "reprox", "jaxtyping"], ["flax"]),
])
def test_forbidden_top_level_names(names, bad):
    assert forbidden_modules(dict.fromkeys(names)) == bad
