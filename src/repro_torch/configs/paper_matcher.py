"""The paper's own workload as an 'architecture': the wave-engine device
program over production-scale matching instances.

Shape cells size the device arrays of the *real* serving program,
``core.engine_step.expand_wave_mq``: the data-graph bitmap, the
slot-stacked query/table banks, wave width, and the slot/depth lanes —
the same multi-query wave the shared-wave scheduler (and the distributed
shard-as-segments matcher on top of it) dispatches, not the 1-slot
facade. These are the dry-run/roofline cells for the paper's technique
itself.
"""
import dataclasses

from .common import ArchSpec, ShapeCell


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    name: str
    n_vertices: int          # data graph |V|
    wave_size: int
    kpr: int
    n_slots: int = 16        # concurrent resident queries (bank slots)
    n_query_max: int = 64
    # bounded hashed Δ store (patterns.store): per-slot capacity, a
    # power of two. Resident pattern memory is S * capacity * ~29 B —
    # independent of n_vertices (the dense [S, N_PAD, V] bank the store
    # replaced was ~0.8 GB/slot at web scale; 64 Ki entries is ~2 MB).
    pattern_capacity: int = 65_536


FULL = MatcherConfig(name="paper-matcher", n_vertices=1_048_576,
                     wave_size=8192, kpr=16)

SMOKE = MatcherConfig(name="matcher-smoke", n_vertices=512,
                      wave_size=64, kpr=4, n_slots=4,
                      pattern_capacity=1024)


def spec() -> ArchSpec:
    shapes = (
        ShapeCell("yeast_scale", "matcher",
                  dict(n_vertices=4096, wave_size=4096, kpr=16,
                       n_slots=16, pattern_capacity=16_384)),
        ShapeCell("web_scale", "matcher",
                  dict(n_vertices=1_048_576, wave_size=8192, kpr=16,
                       n_slots=16, pattern_capacity=65_536)),
        # device-resident scheduling step (run_device_megastep): adds
        # the per-slot StackBank dims — presence of stack_capacity
        # routes build_cell to the stack lowering
        ShapeCell("yeast_scale_stacks", "matcher",
                  dict(n_vertices=4096, wave_size=4096, kpr=16,
                       n_slots=16, pattern_capacity=16_384,
                       stack_capacity=1024, megastep_depth=6)),
    )
    return ArchSpec(arch_id="paper-matcher", family="matcher", config=FULL,
                    smoke_config=SMOKE, shapes=shapes,
                    notes="expand_wave_mq lowered on the production mesh; "
                          "frontier + slot/depth lanes sharded over data "
                          "axis, graph bitmap sharded over model axis, "
                          "hashed pattern store replicated (O(capacity), "
                          "data-graph independent)")
