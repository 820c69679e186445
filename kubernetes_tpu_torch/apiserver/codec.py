"""Binary wire codec for control-plane components.

The reference apiserver negotiates a binary serialization alongside JSON
(``staging/src/k8s.io/apimachinery/pkg/runtime/serializer/protobuf/
protobuf.go``: ``application/vnd.kubernetes.protobuf``) because JSON
encode/decode dominates wire cost at scheduler_perf scale. This module
is the analog: API objects travel as pickled Python objects (protocol
5), negotiated per request via ``Content-Type`` / ``Accept``.

Objects travel as the port's own classes
(``kubernetes_tpu_torch.api.types``): a binary body is only ever
exchanged between the port's processes, never with another package's
server.

Trust model: pickle is only safe between same-codebase control-plane
components (exactly protobuf's deployment envelope in the reference —
kubelet/scheduler/controller-manager speak it, kubectl speaks JSON).
The server therefore only decodes binary BODIES from authenticated
clients (or when it was built with no authentication at all, the
in-process test topology); anonymous remote callers cannot reach the
unpickler. Responses are only pickled when the client explicitly asks
via ``Accept``.
"""

from __future__ import annotations

import pickle
from typing import Any

# the negotiated media type (reference: application/vnd.kubernetes.protobuf)
BINARY_CONTENT_TYPE = "application/vnd.ktpu.binary"

# -- wire-version negotiation (mixed-version skew guard) ---------------
# A rolling upgrade has old and new processes on the wire at once
# (upstream's N/N-1 skew contract). The codec's one observable schema
# change so far is the watch-event frame: v1 streamed ``(type, obj,
# old)`` 3-tuples, v2 streams ``(type, obj, old, commit_ts)`` 4-tuples.
# Decoders were written to accept both, but that is an accident of this
# particular change — the next one may not be shape-sniffable. So the
# contract is made EXPLICIT: the client stamps the highest version it
# speaks on every request (VERSION_HEADER), the server pins the
# connection to ``min(server, client)`` and echoes the pinned stamp
# back; an out-of-range stamp is a 400, never a silent decode skew.
# Absent header → v2 (every current in-tree client already speaks it;
# the stamp exists for the NEXT skew, and for v1-pinned laggards).
CODEC_VERSION = 2
MIN_CODEC_VERSION = 1
VERSION_HEADER = "X-Ktpu-Codec-Version"


def negotiate(client_stamp) -> int:
    """Pin the wire version for one request: ``min(server, client)``.

    ``client_stamp`` is the raw header value (or None when absent).
    Raises ValueError when the stamp is malformed or outside
    [MIN_CODEC_VERSION, ∞) — a client OLDER than the server's floor
    cannot be served and must be told so explicitly (the server no
    longer encodes that schema), and garbage must not default-through
    to a guess."""
    if client_stamp is None:
        return CODEC_VERSION
    v = int(client_stamp)  # ValueError on garbage propagates
    if v < MIN_CODEC_VERSION:
        raise ValueError(
            f"codec version {v} below server floor {MIN_CODEC_VERSION}")
    return min(CODEC_VERSION, v)

# watch streams prefix each frame with a 4-byte big-endian length (the
# reference streams length-delimited protobuf frames the same way:
# runtime/serializer/streaming). A frame's payload is a pickled LIST
# whose elements are per-event pickles (bytes) — encoded once
# server-side and cached on the event (rest.py _cached_event_bytes), so
# coalescing a chunk is a list-of-bytes pickle (memcpy per element),
# never a re-encode. A frame cut mid-event reads as torn (read_frame →
# None): the client relists, exactly like a torn JSON line.
FRAME_LEN_BYTES = 4


def encode(payload: Any) -> bytes:
    return pickle.dumps(payload, protocol=5)


def decode(data: bytes) -> Any:
    return pickle.loads(data)


def frame(payload: Any) -> bytes:
    body = encode(payload)
    return len(body).to_bytes(FRAME_LEN_BYTES, "big") + body


def read_frame(fp) -> Any:
    """Read one length-prefixed frame from a file-like; None on EOF."""
    header = fp.read(FRAME_LEN_BYTES)
    if not header or len(header) < FRAME_LEN_BYTES:
        return None
    n = int.from_bytes(header, "big")
    body = fp.read(n)
    if len(body) < n:
        return None
    return decode(body)
