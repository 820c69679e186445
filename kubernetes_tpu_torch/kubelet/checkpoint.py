"""Checksummed local checkpoint store.

Behavioral equivalent of the reference's kubelet checkpoint manager
(``pkg/kubelet/checkpointmanager/checkpoint_manager.go`` +
``checksum/checksum.go``): named checkpoints persisted to local files with
an integrity checksum, verified on read so a torn write surfaces as
``CorruptCheckpointError`` instead of silent bad state. Used by the device
manager (``pkg/kubelet/cm/devicemanager/checkpoint/checkpoint.go``) to
survive kubelet restarts without losing device assignments.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Any, Dict, List, Optional


class CorruptCheckpointError(Exception):
    pass


def _checksum(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


class CheckpointManager:
    """File-per-checkpoint with atomic replace + CRC verification."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"invalid checkpoint name {name!r}")
        return os.path.join(self.directory, name + ".ckpt")

    def create(self, name: str, data: Any) -> None:
        """Write (atomically): a crash mid-write leaves the old file."""
        payload = json.dumps(data, sort_keys=True).encode()
        doc = json.dumps(
            {"checksum": _checksum(payload), "data": payload.decode()}
        ).encode()
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(doc)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(name))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get(self, name: str) -> Optional[Any]:
        """Read + verify; raises CorruptCheckpointError on checksum
        mismatch, returns None if absent."""
        path = self._path(name)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read())
            payload = doc["data"].encode()
            if _checksum(payload) != doc["checksum"]:
                raise CorruptCheckpointError(f"checkpoint {name!r} checksum mismatch")
            return json.loads(payload)
        except (json.JSONDecodeError, KeyError, UnicodeDecodeError) as e:
            raise CorruptCheckpointError(f"checkpoint {name!r} unreadable: {e}")

    def remove(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def list(self) -> List[str]:
        return sorted(
            f[: -len(".ckpt")]
            for f in os.listdir(self.directory)
            if f.endswith(".ckpt")
        )
