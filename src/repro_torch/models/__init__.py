"""The model zoo of the port (``repro.models`` is its reference): one
``nn.Module`` per model family, whose parameter names follow the
reference's parameter pytree, and the reference's functions by name as
plain functions on those modules and on tensors.

Every constructor and ``*_init`` takes an explicit ``torch.Generator``
where the reference takes a key (draws are made on the generator's own
device, then placed) and ``device`` (``"cuda"`` by default, which needs a
card; ``"cpu"`` for host runs; ``"meta"`` builds the shapes and draws
nothing). ``repro_torch.convert`` loads a reference parameter pytree into
these modules.
"""
