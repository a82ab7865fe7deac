"""Fault tolerance: straggler detection (:mod:`.straggler`), failure
injection (:mod:`.failures`) and elastic re-meshing (:mod:`.elastic`)."""
