"""Fault tolerance: straggler detection (:mod:`.straggler`).  The
reference's elastic re-meshing and failure injection come with the
sweep."""
