"""Resumable per-campaign record store, keyed by the spec's content hash.

The store is split in two layers:

* :class:`RecordStore` — the campaign-level API the planner/runner/
  aggregation layers talk to (``put`` / ``completed`` / ``records``),
  keyed by the spec's content hash so different specs can never share
  records;
* a :class:`RecordStoreBackend` — where the bytes live.  The default
  :class:`LocalDirBackend` is the original one-directory-per-campaign
  layout below; :class:`MemoryBackend` keeps everything in-process
  (tests, ephemeral campaigns).  A sharded / object-store backend for
  million-point campaigns only needs to implement the same four-method
  protocol.

Local-dir layout (one directory per campaign):

.. code-block:: text

    <root>/<name>-<spec_hash>/
        spec.json                     # the full SweepSpec, for audit
        chunks/chunk-000000-000007.json
        chunks/chunk-000008-000015.json
        ...

Each chunk file holds the records of one planned :class:`~repro_torch.sweep.
planner.Chunk` and is written atomically (temp file + ``os.replace``),
so a killed sweep leaves either a complete chunk or no chunk — never a
torn one.  Completion is the existence of the chunk file; a restarted
run lists ``chunks/`` and skips everything already present, which is
the whole resume protocol.  Atomic last-write-wins chunk files also
make *duplicate* execution harmless: two workers racing on the same
re-dispatched chunk replace the file with byte-identical content (see
:func:`repro_torch.sweep.runner.run_sweep_ft`).  Different specs hash to
different directories, so stale records can never satisfy a changed
campaign.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Iterator, Optional, Protocol, runtime_checkable

from repro_torch.sweep.planner import Chunk
from repro_torch.sweep.spec import SweepSpec


@runtime_checkable
class RecordStoreBackend(Protocol):
    """Storage protocol behind a :class:`RecordStore`.

    Implementations must make :meth:`put_chunk` atomic per key (a
    reader never sees a torn chunk) and idempotent under duplicate
    writes of identical content — the fault-tolerant runner relies on
    last-write-wins semantics.  ``location`` is a human-readable
    address used in summaries (a path for the local backend).
    """

    location: str

    def ensure(self) -> None:
        """Create whatever the backend needs before the first write."""
        ...

    def put_chunk(self, key: str, payload: dict) -> None:
        """Persist one chunk payload atomically under ``key``."""
        ...

    def completed(self) -> set[str]:
        """Keys of chunks already stored (the resume set)."""
        ...

    def chunk_payloads(self) -> Iterator[dict]:
        """Every stored chunk payload, in stable key order."""
        ...

    def read_spec(self) -> Optional[str]:
        """The stored spec JSON, or ``None`` if not written yet."""
        ...

    def write_spec(self, text: str) -> None:
        ...


class LocalDirBackend:
    """The default backend: one directory per campaign (see module doc).

    Construction never touches the filesystem (read-only bindings to
    legacy stores must not mkdir); :meth:`ensure` creates the layout.
    """

    def __init__(self, path: str):
        self.location = path
        self._chunk_dir = os.path.join(path, "chunks")
        self._spec_path = os.path.join(path, "spec.json")

    def ensure(self) -> None:
        os.makedirs(self._chunk_dir, exist_ok=True)

    @staticmethod
    def _atomic_write(path: str, text: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def put_chunk(self, key: str, payload: dict) -> None:
        self._atomic_write(os.path.join(self._chunk_dir, key + ".json"),
                           json.dumps(payload))

    def completed(self) -> set[str]:
        if not os.path.isdir(self._chunk_dir):
            return set()
        return {f[:-len(".json")] for f in os.listdir(self._chunk_dir)
                if f.endswith(".json")}

    def chunk_payloads(self) -> Iterator[dict]:
        if not os.path.isdir(self._chunk_dir):
            return
        for f in sorted(os.listdir(self._chunk_dir)):
            if not f.endswith(".json"):
                continue
            with open(os.path.join(self._chunk_dir, f)) as fh:
                yield json.load(fh)

    def read_spec(self) -> Optional[str]:
        if not os.path.exists(self._spec_path):
            return None
        with open(self._spec_path) as f:
            return f.read()

    def write_spec(self, text: str) -> None:
        self._atomic_write(self._spec_path, text)


class MemoryBackend:
    """In-process backend (tests / ephemeral campaigns); thread-safe.

    Payloads round-trip through JSON so records are byte-for-byte what
    the local backend would have stored — parity tests can swap
    backends without losing the serialization boundary.
    """

    def __init__(self, name: str = "anon"):
        self.location = f"memory://{name}"
        self._lock = threading.Lock()
        self._chunks: dict[str, str] = {}
        self._spec: Optional[str] = None

    def ensure(self) -> None:
        pass

    def put_chunk(self, key: str, payload: dict) -> None:
        text = json.dumps(payload)
        with self._lock:
            self._chunks[key] = text

    def completed(self) -> set[str]:
        with self._lock:
            return set(self._chunks)

    def chunk_payloads(self) -> Iterator[dict]:
        with self._lock:
            items = sorted(self._chunks.items())
        for _, text in items:
            yield json.loads(text)

    def read_spec(self) -> Optional[str]:
        with self._lock:
            return self._spec

    def write_spec(self, text: str) -> None:
        with self._lock:
            self._spec = text


class RecordStore:
    """Append-only per-campaign store of per-point success records."""

    def __init__(self, root: str, spec: SweepSpec,
                 backend: Optional[RecordStoreBackend] = None):
        self.spec = spec
        if backend is None:
            backend = LocalDirBackend(os.path.join(root, spec.store_name()))
        self.backend = backend
        self.path = backend.location
        backend.ensure()
        if backend.read_spec() is None:
            backend.write_spec(spec.to_json())

    @classmethod
    def bound(cls, path: str, spec: SweepSpec) -> "RecordStore":
        """Read-only binding to an *existing* campaign directory.

        Unlike the constructor it neither creates directories nor
        re-derives the path from the spec hash, so discovery keeps
        working on stores written under an older physics fingerprint.
        """
        obj = object.__new__(cls)
        obj.spec = spec
        obj.backend = LocalDirBackend(path)
        obj.path = path
        return obj

    # ------------------------------------------------------------ writing
    def put(self, chunk: Chunk, records: list[dict]) -> None:
        """Persist one completed chunk (atomic; marks it done)."""
        payload = {"key": chunk.key, "backend": chunk.backend,
                   "indices": list(chunk.indices), "records": records}
        self.backend.put_chunk(chunk.key, payload)

    # ------------------------------------------------------------ reading
    def completed(self) -> set[str]:
        """Keys of chunks already stored (the resume set)."""
        return self.backend.completed()

    def records(self) -> list[dict]:
        """All stored records, ordered by grid-point index."""
        out: list[dict] = []
        for payload in self.backend.chunk_payloads():
            out.extend(payload["records"])
        out.sort(key=lambda r: r["index"])
        return out

    def n_completed_points(self) -> int:
        return len(self.records())


def discover(root: str) -> Iterator[tuple[SweepSpec, "RecordStore"]]:
    """Iterate every campaign stored under ``root`` (for reporting).

    Binds each store to the directory it was found in (read-only) and
    skips campaigns whose spec no longer parses under the current
    schema, so reporting never crashes on — or mkdirs next to — legacy
    stores.
    """
    if not os.path.isdir(root):
        return
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        spec_path = os.path.join(path, "spec.json")
        if not os.path.exists(spec_path):
            continue
        try:
            with open(spec_path) as f:
                spec = SweepSpec.from_json(f.read())
        except (TypeError, ValueError):
            continue  # written under an older spec schema
        yield spec, RecordStore.bound(path, spec)


def default_root(explicit: Optional[str] = None) -> str:
    """Resolve the record-store root: explicit > ``$REPRO_SWEEP_ROOT`` >
    ``<repo>/results/sweeps``.

    The fallback is repo-relative (not CWD-relative), so every caller
    sees the same stores no matter where it is invoked from.  The port's
    store names carry its own physics fingerprint (see
    :func:`repro_torch.sweep.spec._model_fingerprint`), so its campaigns
    never share a directory with the reference package's.
    """
    if explicit:
        return explicit
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))  # src/repro_torch/..
    return os.environ.get("REPRO_SWEEP_ROOT",
                          os.path.join(repo, "results", "sweeps"))
