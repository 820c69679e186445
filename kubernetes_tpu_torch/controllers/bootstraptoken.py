"""Bootstrap-token controllers (the reference's
``pkg/controller/bootstrap/{bootstrapsigner,tokencleaner}.go``):

- the signer keeps one signature a bootstrap-token Secret
  (``jws-kubeconfig-<token id>``) over the ``cluster-info`` ConfigMap in
  kube-public, so a joining node can check cluster-info with its token
  alone; an HMAC over the kubeconfig with the token's id and secret takes
  the place of the reference's JWS, with the same binding;
- the cleaner deletes bootstrap-token Secrets past their ``expiration``.
"""

from __future__ import annotations

import hashlib
import hmac
import time

from kubernetes_tpu_torch.api.types import ConfigMap
from kubernetes_tpu_torch.controllers.base import Controller

BOOTSTRAP_TOKEN_SECRET_TYPE = "bootstrap.kubernetes.io/token"
KUBE_PUBLIC = "kube-public"
CLUSTER_INFO = "cluster-info"
KUBECONFIG_KEY = "kubeconfig"
JWS_PREFIX = "jws-kubeconfig-"


def sign_payload(payload: str, token_id: str, token_secret: str) -> str:
    return hmac.new(f"{token_id}.{token_secret}".encode(), payload.encode(),
                    hashlib.sha256).hexdigest()


def _bootstrap_tokens(store):
    """Token id -> Secret, of the tokens usable for signing."""
    out = {}
    for s in store.list_objects("Secret"):
        if s.type != BOOTSTRAP_TOKEN_SECRET_TYPE:
            continue
        token_id = s.data.get("token-id")
        if token_id and s.data.get("token-secret") and \
                s.data.get("usage-bootstrap-signing") == "true":
            out[token_id] = s
    return out


class BootstrapSignerController(Controller):
    name = "bootstrapsigner"
    RESYNC_SECONDS = 5.0

    def register(self) -> None:
        self.factory.informer_for("Secret").add_event_handler(
            on_add=lambda s: self.enqueue_key("sign"),
            on_update=lambda o, n: self.enqueue_key("sign"),
            on_delete=lambda s: self.enqueue_key("sign"),
        )
        self.factory.informer_for("ConfigMap").add_event_handler(
            on_add=lambda c: self.enqueue_key("sign"),
            on_update=lambda o, n: self.enqueue_key("sign"),
        )

    def resync(self) -> None:
        self.enqueue_key("sign")

    def sync(self, key: str) -> None:
        cm = self.store.get_object("ConfigMap", KUBE_PUBLIC, CLUSTER_INFO)
        if cm is None:
            return
        payload = cm.data.get(KUBECONFIG_KEY, "")
        want = {JWS_PREFIX + tid: sign_payload(payload, tid,
                                               s.data["token-secret"])
                for tid, s in _bootstrap_tokens(self.store).items()}
        have = {k: v for k, v in cm.data.items() if k.startswith(JWS_PREFIX)}
        if have == want:
            return

        def mutate(c: ConfigMap) -> bool:
            data = {k: v for k, v in c.data.items()
                    if not k.startswith(JWS_PREFIX)}
            data.update(want)
            if data == c.data:
                return False
            c.data = data
            return True

        self.store.mutate_object("ConfigMap", KUBE_PUBLIC, CLUSTER_INFO,
                                 mutate)


class TokenCleanerController(Controller):
    name = "tokencleaner"
    RESYNC_SECONDS = 5.0

    def register(self) -> None:
        pass

    def resync(self) -> None:
        self.enqueue_key("sweep")

    def sync(self, key: str) -> None:
        now = time.time()
        for s in self.store.list_objects("Secret"):
            if s.type != BOOTSTRAP_TOKEN_SECRET_TYPE:
                continue
            try:
                expired = float(s.data.get("expiration") or "inf") <= now
            except ValueError:
                continue
            if expired:
                self.store.delete_object("Secret", s.namespace, s.name)
