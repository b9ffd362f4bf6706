"""Archive extraction (counterpart of ``deeplearning4j_tpu/utils/archive.py``;
reference ArchiveUtils.unzipFileTo for .zip / .tar / .tar.gz / .tgz /
.gz, used by the dataset fetchers). An entry that would land outside the
destination (zip-slip, ``../`` or an absolute path) is refused before
anything is written."""

from __future__ import annotations

import gzip
import os
import shutil
import tarfile
import zipfile

__all__ = ["unzip_file_to"]


def _check_dest(dest_dir: str, target: str):
    dest = os.path.realpath(dest_dir)
    tgt = os.path.realpath(target)
    if not (tgt == dest or tgt.startswith(dest + os.sep)):
        raise ValueError(f"Archive entry escapes destination: {target}")


def unzip_file_to(archive: str, dest_dir: str):
    """Extract any supported archive into ``dest_dir`` (reference
    ArchiveUtils.unzipFileTo)."""
    os.makedirs(dest_dir, exist_ok=True)
    lower = archive.lower()
    if lower.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            for info in z.infolist():
                _check_dest(dest_dir, os.path.join(dest_dir, info.filename))
            z.extractall(dest_dir)
    elif lower.endswith((".tar", ".tar.gz", ".tgz")):
        mode = "r:gz" if lower.endswith((".tar.gz", ".tgz")) else "r"
        with tarfile.open(archive, mode) as t:
            # filter="data" also refuses symlink, absolute and device
            # entries, which a name check cannot catch
            t.extractall(dest_dir, filter="data")
    elif lower.endswith(".gz"):
        out = os.path.join(dest_dir, os.path.basename(archive)[:-3])
        with gzip.open(archive, "rb") as f, open(out, "wb") as o:
            shutil.copyfileobj(f, o)
    else:
        raise ValueError(f"Unsupported archive format: {archive}")
