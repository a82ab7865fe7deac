"""Data: deterministic, step-keyed synthetic LM batches and document
packing (:mod:`.pipeline`, numpy only)."""
