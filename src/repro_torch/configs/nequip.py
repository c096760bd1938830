"""nequip — O(3)-equivariant potential, 5 layers, 32 channels, l_max=2.
[arXiv:2101.03164; paper]

Adaptation note (DESIGN.md): irreps are carried in Cartesian form
(scalars / vectors / traceless-sym rank-2) — exact for l_max=2; e3nn is
unavailable offline. Citation-graph shape cells get synthetic 3D
positions (those datasets carry no coordinates).
"""
from ..models.equivariant import EquivConfig
from .common import ArchSpec, gnn_shapes

FULL = EquivConfig(name="nequip", kind="nequip", n_layers=5, channels=32,
                   n_species=64, n_rbf=8, cutoff=5.0, l_max=2,
                   correlation=1)

SMOKE = EquivConfig(name="nequip-smoke", kind="nequip", n_layers=2,
                    channels=8, n_species=8, n_rbf=4, cutoff=5.0,
                    correlation=1)


def spec() -> ArchSpec:
    return ArchSpec(arch_id="nequip", family="equiv", config=FULL,
                    smoke_config=SMOKE, shapes=gnn_shapes(),
                    notes="E(3) tensor-product messages, energy+forces")
