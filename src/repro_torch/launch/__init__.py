"""Entry points of the port that drive a whole job (``repro.launch`` is
its reference): ``train``, the LM training driver with checkpoint and
restart. The mesh, sharding, step builders and dry-run of the reference
are not ported yet (ROADMAP queue 1 item 9).
"""
