"""Entry points of the port that drive a whole job (``repro.launch`` is
its reference): ``train``, the LM training driver with checkpoint and
restart; ``mesh``, ``sharding`` and ``steps``, the production meshes,
the partition rules and the per-(arch x shape) step cells. The LM
cells' steps wait for the models' mesh paths (ROADMAP queue 1 item 9b);
the dry-run is not ported yet (item 9c).
"""
