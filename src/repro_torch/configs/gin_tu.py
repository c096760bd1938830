"""gin-tu — 5-layer GIN, sum aggregator, learnable eps.
[arXiv:1810.00826; paper]"""
from ..models.gnn import GNNConfig
from .common import ArchSpec, gnn_shapes

FULL = GNNConfig(name="gin-tu", kind="gin", n_layers=5, d_in=1433,
                 d_hidden=64, n_classes=7, aggregator="sum",
                 learnable_eps=True, sym_norm=False)

SMOKE = GNNConfig(name="gin-smoke", kind="gin", n_layers=3, d_in=16,
                  d_hidden=16, n_classes=3, aggregator="sum",
                  sym_norm=False)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="gin-tu", family="gnn", config=FULL,
                    smoke_config=SMOKE, shapes=gnn_shapes(),
                    notes="sum aggregation + 2-layer MLP per hop; "
                          "d_in/n_classes follow each shape cell")
