"""Checksummed checkpoint journal + atomic commit primitives.

Crash consistency contract (checkpoint/manager.py is the only writer):

1. checkpoint bytes are committed atomically through a
   :class:`~deeplearning4j_tpu_torch.checkpoint.storage.StorageBackend` — on the
   local filesystem that is ``<dir>/tmp/`` + fsync + ``os.replace`` (atomic
   on POSIX) + directory fsync, so a crash mid-write leaves only a ``tmp/``
   orphan, never a half-written ``ckpt-*.zip``; on an object store a put is
   whole-object atomic by construction;
2. only AFTER the payload is durable is its entry (with the payload's
   sha256) journaled into ``manifest.json``, itself rewritten atomically
   with an embedded checksum over the entries payload.

So at every instant the manifest describes only fully-committed objects,
and a torn manifest or a bit-rotted checkpoint is DETECTED (self-checksum /
per-entry sha256) instead of restored: ``restore_latest`` falls back entry
by entry, and a missing or corrupt manifest degrades to scanning the
backend, where the zip layer's CRC checks still reject torn payloads. The
journal/fallback logic is identical through every backend — only the five
byte-store ops differ.

``load_manifest`` / ``write_manifest`` / ``scan_checkpoint_files`` accept a
directory path (wrapped in a LocalFSBackend, the historical signature) or
any ``StorageBackend``.

Counterpart of ``deeplearning4j_tpu/checkpoint/manifest.py``: the same
journal, byte for byte, so either package's manager reads the other's
directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import List, Optional

MANIFEST_NAME = "manifest.json"
TMP_DIR = "tmp"
MANIFEST_VERSION = 1


class ManifestError(RuntimeError):
    """The manifest exists but is torn/corrupt (invalid JSON, bad
    self-checksum, or wrong shape)."""


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _entries_checksum(entries: List[dict]) -> str:
    payload = json.dumps(entries, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def _fsync_dir(directory: str):
    # directory fsync makes the rename itself durable; some filesystems
    # (or platforms) don't support opening a directory — best effort there
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(directory: str, name: str, data: bytes,
                       fsync_directory: bool = True) -> str:
    """Write ``data`` as ``<directory>/<name>`` via tmp/ + fsync + rename.
    Returns the final path. Callers see either the complete new file or no
    file — never a prefix.

    ``fsync_directory=False`` skips making the RENAME itself durable —
    valid only when the caller immediately follows with another
    atomic write in the SAME directory whose dir-fsync covers this one
    (the manager's payload-then-manifest commit: the entry only becomes
    durable together with, never before, the payload's directory entry)."""
    tmp_dir = os.path.join(directory, TMP_DIR)
    os.makedirs(tmp_dir, exist_ok=True)
    # nested names ("shards/x.npz", the data-lake key shape) stage FLAT in
    # tmp/ and land under their subdirectory on the rename
    fd, tmp_path = tempfile.mkstemp(dir=tmp_dir,
                                    prefix=name.replace(os.sep, "_")
                                               .replace("/", "_") + ".",
                                    suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(directory, name)
        parent = os.path.dirname(final)
        if parent and not os.path.isdir(parent):
            os.makedirs(parent, exist_ok=True)
        os.replace(tmp_path, final)
    except BaseException:
        try:
            os.remove(tmp_path)
        except OSError:
            pass
        raise
    if fsync_directory:
        _fsync_dir(directory)
    return final


def clean_tmp(directory: str):
    """Remove orphaned partial writes left by a crash mid-checkpoint."""
    tmp_dir = os.path.join(directory, TMP_DIR)
    if not os.path.isdir(tmp_dir):
        return
    for name in os.listdir(tmp_dir):
        try:
            os.remove(os.path.join(tmp_dir, name))
        except OSError:
            pass


def _as_backend(target):
    # deferred import: storage.py imports atomic_write_bytes from here
    from deeplearning4j_tpu_torch.checkpoint.storage import as_backend
    return as_backend(target)


def write_manifest(target, entries: List[dict]):
    """Atomically rewrite the journal with a self-checksum over its entries.
    ``target`` is a directory path or a StorageBackend."""
    body = {"version": MANIFEST_VERSION, "entries": entries,
            "checksum": _entries_checksum(entries)}
    _as_backend(target).put(MANIFEST_NAME,
                            json.dumps(body, indent=1).encode())


def load_manifest(target) -> Optional[List[dict]]:
    """Entries from the journal; ``None`` when no manifest exists yet.
    Raises :class:`ManifestError` on a torn/corrupt manifest — callers fall
    back to :func:`scan_checkpoint_files`. ``target`` is a directory path
    or a StorageBackend."""
    from deeplearning4j_tpu_torch.checkpoint.storage import (StorageError,
                                                       StorageNotFoundError)
    backend = _as_backend(target)
    try:
        raw = backend.get(MANIFEST_NAME)
    except StorageNotFoundError:
        return None
    except (OSError, StorageError) as e:
        # present-but-unreadable (EACCES/EIO on a flaky mount, a store
        # outage): surface as a torn manifest so the manager falls back to
        # its rebuild-from-scan path instead of failing construction
        raise ManifestError(
            f"unreadable manifest at {backend.describe()}/{MANIFEST_NAME}: "
            f"{type(e).__name__}: {e}") from e
    try:
        body = json.loads(raw.decode("utf-8"))
        entries = body["entries"]
        if not isinstance(entries, list):
            raise TypeError("entries is not a list")
        if body.get("checksum") != _entries_checksum(entries):
            raise ValueError("manifest self-checksum mismatch")
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise ManifestError(
            f"corrupt manifest at {backend.describe()}/{MANIFEST_NAME}: "
            f"{e}") from e
    return entries


def scan_checkpoint_files(target) -> List[dict]:
    """Degraded-mode recovery: entries (without sha256) for every
    ``ckpt-*.zip`` present, in name (= commit) order. Used when the
    manifest itself was lost or torn; the zip CRC layer still guards each
    payload's integrity during restore. ``target`` is a directory path or
    a StorageBackend."""
    names = _as_backend(target).list(prefix="ckpt-")
    return [{"file": n, "sha256": None} for n in names
            if n.endswith(".zip")]
