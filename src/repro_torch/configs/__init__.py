"""The architecture registry and the published configurations (twin of
``repro.configs``): the same ``FULL`` and ``SMOKE`` values, built from
the port's config dataclasses (torch dtypes where the reference has jnp
ones)."""
