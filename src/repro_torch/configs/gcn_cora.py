"""gcn-cora — 2-layer GCN, sym-norm. [arXiv:1609.02907; paper]"""
from ..models.gnn import GNNConfig
from .common import ArchSpec, gnn_shapes

FULL = GNNConfig(name="gcn-cora", kind="gcn", n_layers=2, d_in=1433,
                 d_hidden=16, n_classes=7, aggregator="mean",
                 sym_norm=True)

SMOKE = GNNConfig(name="gcn-smoke", kind="gcn", n_layers=2, d_in=32,
                  d_hidden=8, n_classes=4, sym_norm=True)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="gcn-cora", family="gnn", config=FULL,
                    smoke_config=SMOKE, shapes=gnn_shapes(),
                    notes="SpMM regime; d_in/n_classes follow each shape "
                          "cell (config dims are the Cora cell)")
