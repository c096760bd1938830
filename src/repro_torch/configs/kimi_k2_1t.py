"""kimi-k2-1t-a32b — trillion-param MoE (384 experts top-8, MLA, 64 heads).
[arXiv:2501.kimi2; unverified — paper-table config]"""
from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .common import ArchSpec, lm_shapes

FULL = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, vocab=163840, rope_theta=5e4,
    mla=MLAConfig(d_model=7168, n_heads=64, d_c=512, d_cq=1536,
                  d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
                  d_ff_shared=2048))

SMOKE = LMConfig(
    name="kimi-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256,
    mla=MLAConfig(d_model=64, n_heads=4, d_c=32, d_cq=48, d_nope=16,
                  d_rope=8, d_v=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                  d_ff_shared=32, capacity_factor=8.0),
    remat=False)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="kimi-k2-1t-a32b", family="lm", config=FULL,
                    smoke_config=SMOKE, shapes=lm_shapes(),
                    notes="1T total / 32B active, 384 routed experts")
