"""qwen3-0.6b — dense GQA LM with qk_norm. [hf:Qwen/Qwen3-0.6B; hf]"""
from ..models.transformer import LMConfig
from .common import ArchSpec, lm_shapes

FULL = LMConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
    n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151936,
    qkv_bias=False, qk_norm=True, rope_theta=1e6, mlp="swiglu")

SMOKE = LMConfig(
    name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    qk_norm=True, mlp="swiglu", remat=False)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="qwen3-0.6b", family="lm", config=FULL,
                    smoke_config=SMOKE, shapes=lm_shapes(),
                    notes="qk_norm, GQA kv=8")
