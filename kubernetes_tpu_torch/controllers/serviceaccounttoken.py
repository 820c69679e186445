"""ServiceAccount token controller.

The reference's ``pkg/controller/serviceaccount/tokens_controller.go``
(NewTokensController): every ServiceAccount has a token Secret (type
``kubernetes.io/service-account-token``) made by this loop and named in
``sa.secrets``; a token Secret whose account is gone, or whose recorded
uid is not the account's (an account deleted and made again under the
same name must not inherit the old credential), is deleted. An opaque
random token takes the place of the reference's signed JWT. This port's
apiserver does not authenticate these tokens yet.
"""

from __future__ import annotations

import secrets as _secrets

from kubernetes_tpu_torch.api.types import ObjectMeta, Secret
from kubernetes_tpu_torch.controllers.base import Controller, split_key

SA_TOKEN_TYPE = "kubernetes.io/service-account-token"
SA_NAME_ANNOTATION = "kubernetes.io/service-account.name"
SA_UID_ANNOTATION = "kubernetes.io/service-account.uid"


def sa_username(namespace: str, name: str) -> str:
    """The identity a service-account token stands for
    (``pkg/serviceaccount/util.go`` MakeUsername)."""
    return f"system:serviceaccount:{namespace}:{name}"


class TokensController(Controller):
    name = "serviceaccount-token"

    def register(self) -> None:
        self.factory.informer_for("ServiceAccount").add_event_handler(
            on_add=self.enqueue,
            on_update=lambda old, new: self.enqueue(new),
            on_delete=self.enqueue,
        )
        # a deleted token is made again; one whose account is gone is
        # deleted by the same sync
        self.factory.informer_for("Secret").add_event_handler(
            on_add=self._secret_changed,
            on_delete=self._secret_changed,
        )

    def _secret_changed(self, secret: Secret) -> None:
        if secret.type != SA_TOKEN_TYPE:
            return
        sa_name = secret.metadata.annotations.get(SA_NAME_ANNOTATION)
        if sa_name:
            self.enqueue_key(f"{secret.namespace}/{sa_name}")

    def _token_secrets(self, namespace: str, sa_name: str):
        return [s for s in self.store.list_objects("Secret", namespace)
                if s.type == SA_TOKEN_TYPE
                and s.metadata.annotations.get(SA_NAME_ANNOTATION) == sa_name]

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        sa = self.store.get_service_account(ns, name)
        existing = self._token_secrets(ns, name)
        if sa is None:
            for s in existing:
                self.store.delete_object("Secret", ns, s.name)
            return
        live = []
        for s in existing:
            if s.metadata.annotations.get(SA_UID_ANNOTATION) == sa.metadata.uid:
                live.append(s)
            else:
                self.store.delete_object("Secret", ns, s.name)
        if not live:
            secret_name = f"{name}-token-{_secrets.token_hex(3)}"
            self.store.create_object("Secret", Secret(
                metadata=ObjectMeta(
                    name=secret_name, namespace=ns,
                    annotations={SA_NAME_ANNOTATION: name,
                                 SA_UID_ANNOTATION: sa.metadata.uid}),
                type=SA_TOKEN_TYPE,
                data={"token": _secrets.token_urlsafe(24), "namespace": ns},
            ))
            live = [self.store.get_object("Secret", ns, secret_name)]
        wanted = sorted(s.name for s in live)

        def mutate(obj) -> bool:
            if obj.secrets == wanted:
                return False
            obj.secrets = wanted
            return True

        self.store.mutate_object("ServiceAccount", ns, name, mutate)
