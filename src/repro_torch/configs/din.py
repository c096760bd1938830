"""din — Deep Interest Network, target attention over user history.
[arXiv:1706.06978; paper]

Table sizes follow the production regime the taxonomy prescribes
(10^6–10^9 rows): 100M items / 100k categories, dim 18.
"""
from ..models.recsys import DINConfig
from .common import ArchSpec, recsys_shapes

FULL = DINConfig(name="din", n_items=100_000_000, n_cats=100_000,
                 embed_dim=18, seq_len=100, attn_hidden=(80, 40),
                 mlp_hidden=(200, 80), n_dense_feats=8)

SMOKE = DINConfig(name="din-smoke", n_items=1000, n_cats=50,
                  embed_dim=8, seq_len=10, attn_hidden=(16, 8),
                  mlp_hidden=(32, 16), n_dense_feats=4)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="din", family="recsys", config=FULL,
                    smoke_config=SMOKE, shapes=recsys_shapes(),
                    notes="embedding-bag = take + segment_sum; "
                          "retrieval cell scores 1e6 candidates batched")
