"""deepseek-v3-671b — MLA + 256-expert top-8 MoE + MTP.
[arXiv:2412.19437; hf]

Deviation from the HF config (recorded in DESIGN.md): all 61 layers are
MoE (the release keeps the first 3 dense); total params land at ~692B vs
671B, activated ~37B matches the paper.
"""
from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .common import ArchSpec, lm_shapes

FULL = LMConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, d_ff=2048, vocab=129280, rope_theta=1e4,
    mla=MLAConfig(d_model=7168, n_heads=128, d_c=512, d_cq=1536,
                  d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  d_ff_shared=2048),
    mtp=True)

SMOKE = LMConfig(
    name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
    mla=MLAConfig(d_model=64, n_heads=4, d_c=32, d_cq=48, d_nope=16,
                  d_rope=8, d_v=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                  d_ff_shared=32, capacity_factor=8.0),
    mtp=True, remat=False)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="deepseek-v3-671b", family="lm", config=FULL,
                    smoke_config=SMOKE, shapes=lm_shapes(),
                    notes="MLA latent KV cache, 1 shared + 256 routed "
                          "top-8, MTP head")
