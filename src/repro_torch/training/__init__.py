"""Training of the port's models (``repro.training`` is its reference):
AdamW with global-norm clipping and a cosine schedule over ``{name:
tensor}`` mappings, updated in place (``optimizer``), and atomic
checkpoints written in the reference's on-disk format, so that either
package restores the other's (``checkpoint``).
"""
