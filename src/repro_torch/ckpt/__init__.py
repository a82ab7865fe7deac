"""Checkpoints: the shared on-disk format (:mod:`.checkpoint`) and the
X-replica store that majority-votes them on restore (:mod:`.tmr_store`)."""
