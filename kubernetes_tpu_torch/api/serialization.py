"""Wire codec: typed API objects to JSON-able dicts and back.

A kind registry (``SCHEME``) and a generic encoder and decoder over the
dataclass API types, with the Kubernetes wire conventions (camelCase
keys, quantity strings, a ``kind`` discriminator). This is what crosses
the HTTP boundary between the REST server
(``kubernetes_tpu_torch.apiserver.rest``) and remote clients; the same
dicts, key for key, as the JAX package's ``api/serialization.py``.

Encoding rules:
- dataclass field names snake_case → camelCase
- ``Quantity`` → canonical string (whole units, milli, or nano suffix)
- empty containers / default-equal scalars are elided (compact wire form)
- every top-level object carries ``{"kind": ..., "apiVersion": "v1"}``
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, get_args, get_origin, get_type_hints

from kubernetes_tpu_torch.api import types as api_types
from kubernetes_tpu_torch.api.labels import Requirement
from kubernetes_tpu_torch.api.resource import _NANO, Quantity

# ---------------------------------------------------------------------------
# Scheme: the kind registry

SCHEME: Dict[str, type] = {
    name: getattr(api_types, name)
    for name in (
        "Pod",
        "Node",
        "Service",
        "ReplicaSet",
        "ReplicationController",
        "StatefulSet",
        "PersistentVolumeClaim",
        "PersistentVolume",
        "StorageClass",
        "CSINode",
        "PodDisruptionBudget",
        "Event",
        "Namespace",
        "ResourceQuota",
        "ServiceAccount",
        "Role",
        "ClusterRole",
        "RoleBinding",
        "ClusterRoleBinding",
        "Secret",
        "ConfigMap",
        "PriorityClass",
        "Lease",
    )
}


# schema metadata: which kinds are namespace-scoped (clients need this to
# build paths; it is API schema, not storage layout)
CLUSTER_SCOPED = {"Node", "PersistentVolume", "StorageClass", "CSINode",
                  "PriorityClass",
                  "Namespace", "ClusterRole", "ClusterRoleBinding"}


def is_namespaced(kind: str) -> bool:
    return kind not in CLUSTER_SCOPED


def kind_of(obj: Any) -> str:
    k = type(obj).__name__
    if k not in SCHEME:
        raise TypeError(f"unregistered kind {k!r}")
    return k


def _camel(s: str) -> str:
    head, *rest = s.split("_")
    return head + "".join(w.capitalize() for w in rest)


def quantity_to_string(q: Quantity) -> str:
    n = q.nano
    if n % _NANO == 0:
        return str(n // _NANO)
    if n % 10**6 == 0:
        return f"{n // 10**6}m"
    return f"{n}n"


def _encode(value: Any) -> Any:
    if isinstance(value, Quantity):
        return quantity_to_string(value)
    if isinstance(value, Requirement):
        return {
            "key": value.key,
            "operator": value.operator,
            "values": list(value.values),
        }
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {}
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            if v is None:
                continue
            if isinstance(v, (dict, list, tuple)) and not v:
                continue
            out[_camel(f.name)] = _encode(v)
        return out
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    return value


def to_wire(obj: Any) -> Dict[str, Any]:
    """Encode a typed object for the wire, with its kind discriminator."""
    d = _encode(obj)
    d["kind"] = kind_of(obj)
    d["apiVersion"] = "v1"
    return d


# ---------------------------------------------------------------------------
# Decoding: reflection over dataclass type hints

_hints_cache: Dict[type, Dict[str, Any]] = {}


def _hints(cls: type) -> Dict[str, Any]:
    h = _hints_cache.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _hints_cache[cls] = h
    return h


def _decode(hint: Any, value: Any) -> Any:
    if value is None:
        return None
    origin = get_origin(hint)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in get_args(hint) if a is not type(None)]
        return _decode(args[0], value) if args else value
    if hint is Quantity:
        from kubernetes_tpu_torch.api.resource import parse_quantity

        return parse_quantity(value)
    if hint is Requirement:
        return Requirement(
            value["key"], value["operator"], tuple(value.get("values") or ())
        )
    if dataclasses.is_dataclass(hint):
        hints = _hints(hint)
        kwargs = {}
        for f in dataclasses.fields(hint):
            wire_key = _camel(f.name)
            if wire_key in value:
                kwargs[f.name] = _decode(hints[f.name], value[wire_key])
        return hint(**kwargs)
    if origin in (dict, typing.Dict):
        kh, vh = (get_args(hint) + (Any, Any))[:2]
        return {k: _decode(vh, v) for k, v in value.items()}
    if origin in (list, typing.List):
        (eh,) = get_args(hint) or (Any,)
        return [_decode(eh, v) for v in value]
    if origin in (tuple, typing.Tuple):
        args = get_args(hint)
        eh = args[0] if args else Any
        return tuple(_decode(eh, v) for v in value)
    return value


def from_wire(d: Dict[str, Any], kind: Optional[str] = None) -> Any:
    """Decode a wire dict into its typed object (kind from the payload's
    discriminator unless given explicitly). A kind outside ``SCHEME``
    raises ``TypeError``: custom resources are not served."""
    k = kind or d.get("kind")
    if not k:
        raise TypeError("cannot decode object with no kind")
    cls = SCHEME.get(k)
    if cls is None:
        raise TypeError(f"unregistered kind {k!r}")
    body = {key: v for key, v in d.items() if key not in ("kind", "apiVersion")}
    return _decode(cls, body)


def roundtrip_equal(obj: Any) -> bool:
    """Debug helper: does obj survive encode→decode→encode?"""
    w = to_wire(obj)
    return to_wire(from_wire(w)) == w
