"""starcoder2-15b — dense GQA code LM, GELU MLP. [arXiv:2402.19173; hf]"""
from ..models.transformer import LMConfig
from .common import ArchSpec, lm_shapes

FULL = LMConfig(
    name="starcoder2-15b", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=4, head_dim=128, d_ff=24576, vocab=49152,
    qkv_bias=True, rope_theta=1e5, mlp="gelu")

SMOKE = LMConfig(
    name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=256, vocab=256,
    qkv_bias=True, mlp="gelu", remat=False)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="starcoder2-15b", family="lm", config=FULL,
                    smoke_config=SMOKE, shapes=lm_shapes(),
                    notes="GQA kv=4, RoPE, GELU MLP")
