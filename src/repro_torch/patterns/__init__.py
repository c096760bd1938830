"""Failure-pattern subsystem of the port (twin of ``repro.patterns``).

* ``store``  — the bounded hashed Δ store on tensors plus the host
  *entries* form;
* ``cache``  — the cross-query template cache (numpy, a copy);
* ``tables`` — the sequential host reference tables (numpy, a copy).
"""
from .cache import CacheStats, PatternCache
from .store import (ENTRY_KEYS, MASK_WORDS, PROBE, PatternStore,
                    PatternStoreBank, StoreCounters, age_hits,
                    empty_entries, entries_to_store, hash_insert,
                    hash_probe, mask64, probe_slots, select_entries,
                    store_to_entries, words_from64)
from .tables import DeadEndStats, NumericDeadEndTable, SetDeadEndTable

__all__ = [
    "CacheStats", "PatternCache",
    "ENTRY_KEYS", "MASK_WORDS", "PROBE", "PatternStore",
    "PatternStoreBank", "StoreCounters", "age_hits", "empty_entries",
    "entries_to_store", "hash_insert", "hash_probe", "mask64",
    "probe_slots", "select_entries", "store_to_entries", "words_from64",
    "DeadEndStats", "NumericDeadEndTable", "SetDeadEndTable",
]
