"""The versioned scheme, as far as the built-in kinds need it: every
kind is served at the internal version ``v1`` (the hub: the typed
scheme of ``api/serialization.py``) and at no other, so decoding and
encoding are the plain wire codec. The JAX package registers group
versions with their conversions and defaulting on the same interface
(``recognizes``, ``decode``, ``encode``); none is ported."""

from __future__ import annotations

from typing import Any, Dict

from kubernetes_tpu_torch.api.serialization import from_wire, to_wire

INTERNAL_VERSION = "v1"  # the hub: the legacy core routes serve it


class VersionedScheme:
    """The hub alone."""

    def recognizes(self, api_version: str, kind: str) -> bool:
        return api_version == INTERNAL_VERSION

    def decode(self, body: Dict[str, Any], kind: str,
               api_version: str) -> Any:
        """Wire dict -> typed object (``api_version`` is the hub)."""
        return from_wire(body, kind)

    def encode(self, obj: Any, api_version: str) -> Dict[str, Any]:
        """Typed object -> wire dict (``api_version`` is the hub)."""
        return to_wire(obj)


SCHEME_V = VersionedScheme()
