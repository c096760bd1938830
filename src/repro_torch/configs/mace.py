"""mace — higher-order equivariant message passing (ACE), 2 layers,
128 channels, correlation order 3. [arXiv:2206.07697; paper]"""
from ..models.equivariant import EquivConfig
from .common import ArchSpec, gnn_shapes

FULL = EquivConfig(name="mace", kind="mace", n_layers=2, channels=128,
                   n_species=64, n_rbf=8, cutoff=5.0, l_max=2,
                   correlation=3)

SMOKE = EquivConfig(name="mace-smoke", kind="mace", n_layers=2,
                    channels=8, n_species=8, n_rbf=4, cutoff=5.0,
                    correlation=3)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="mace", family="equiv", config=FULL,
                    smoke_config=SMOKE, shapes=gnn_shapes(),
                    notes="correlation-3 products of aggregated features "
                          "(many-body terms from one sweep)")
