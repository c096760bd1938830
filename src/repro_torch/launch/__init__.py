"""Entry points of the port that drive a whole job (``repro.launch`` is
its reference): ``train``, the LM training driver with checkpoint and
restart; ``mesh``, ``sharding`` and ``steps``, the production meshes,
the partition rules and the per-(arch x shape) step cells; ``dryrun``,
which counts every cell on the production meshes without a card or a
compiler.
"""
