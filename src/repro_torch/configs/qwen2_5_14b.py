"""qwen2.5-14b — dense GQA LM with QKV bias. [hf:Qwen/Qwen2.5-14B; hf]"""
from ..models.transformer import LMConfig
from .common import ArchSpec, lm_shapes

FULL = LMConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=13824, vocab=152064,
    qkv_bias=True, qk_norm=False, rope_theta=1e6, mlp="swiglu")

SMOKE = LMConfig(
    name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    qkv_bias=True, qk_norm=False, mlp="swiglu", remat=False)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="qwen2.5-14b", family="lm", config=FULL,
                    smoke_config=SMOKE, shapes=lm_shapes(),
                    notes="GQA kv=8, QKV bias")
