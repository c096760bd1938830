"""Roofline terms of a step cell (twin of ``repro.roofline``):
``hlo_cost`` counts one run of a cell on ``meta`` tensors, ``analysis``
turns the counts into compute, memory and collective times on an H100.
"""
