"""VolumeBinding (reference ``plugins/volumebinding/volume_binding.go`` +
``pkg/controller/volume/scheduling`` SchedulerVolumeBinder): the stateful
plugin spanning PreFilter+Filter+Reserve+PreBind+Unreserve.

Semantics carried over:
- bound PVCs: the PV's node affinity must admit the node;
- unbound PVCs with an Immediate storage class: unschedulable
  ("pod has unbound immediate PersistentVolumeClaims");
- unbound PVCs with WaitForFirstConsumer: try to match an available PV
  (capacity/class/access-modes/node-affinity); if none, the class may
  provision → feasible;
- Reserve assumes the PV→PVC match, PreBind commits it through the API,
  Unreserve rolls back.
"""

from typing import Dict, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.scheduler.framework.interface import (
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    FilterPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    ReservePlugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.framework.plugins.helpers import (
    node_matches_node_selector,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo

PRE_FILTER_STATE_KEY = "PreFilterVolumeBinding"

ERR_REASON_BIND_CONFLICT = "node(s) didn't find available persistent volumes to bind"
ERR_REASON_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_REASON_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
ERR_REASON_PVC_NOT_FOUND = "persistentvolumeclaim not found"


class _PodVolumes:
    __slots__ = ("bound_claims", "claims_to_bind", "matches",
                 "candidates", "node_independent", "cached_chosen")

    def __init__(self):
        self.bound_claims = []   # PVCs already bound to a PV
        self.claims_to_bind = []  # WaitForFirstConsumer PVCs needing a PV
        self.matches: Dict[str, Dict[str, str]] = {}  # node -> {pvc key: pv name}
        # per-class candidate PV lists, built ONCE in PreFilter (the
        # reference's volume binder keeps an indexed PV cache; a per-
        # (pod, node) scan of every PV in the cluster is quadratic)
        self.candidates: Dict[str, list] = {}
        # True when no candidate carries node affinity: the match result
        # is identical on every node, so Filter computes it once
        self.node_independent = False
        self.cached_chosen: Optional[Dict[str, str]] = None

    def clone(self):
        c = _PodVolumes()
        c.bound_claims = list(self.bound_claims)
        c.claims_to_bind = list(self.claims_to_bind)
        c.matches = {n: dict(m) for n, m in self.matches.items()}
        c.candidates = {k: list(v) for k, v in self.candidates.items()}
        c.node_independent = self.node_independent
        c.cached_chosen = (
            dict(self.cached_chosen)
            if self.cached_chosen is not None else None
        )
        return c


class VolumeBinding(PreFilterPlugin, FilterPlugin, ReservePlugin, PreBindPlugin):
    NAME = "VolumeBinding"

    @staticmethod
    def factory(args, handle):
        return VolumeBinding(handle)

    def __init__(self, handle=None):
        self.handle = handle
        # pv name -> pvc key assumed during Reserve, per pod uid
        self._assumed: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------------
    def pre_filter(self, state, pod: Pod) -> Optional[Status]:
        client = self.handle.client
        pv = _PodVolumes()
        for vol in pod.spec.volumes:
            claim_name = vol.persistent_volume_claim
            if not claim_name:
                continue
            pvc = client.get_pvc(pod.namespace, claim_name)
            if pvc is None:
                return Status(
                    UNSCHEDULABLE_AND_UNRESOLVABLE,
                    f'{ERR_REASON_PVC_NOT_FOUND} "{claim_name}"',
                )
            if pvc.volume_name:
                pv.bound_claims.append(pvc)
                continue
            sc = (
                client.get_storage_class(pvc.storage_class_name)
                if pvc.storage_class_name
                else None
            )
            if sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer":
                pv.claims_to_bind.append(pvc)
            else:
                return Status(
                    UNSCHEDULABLE_AND_UNRESOLVABLE, ERR_REASON_UNBOUND_IMMEDIATE
                )
        if pv.claims_to_bind:
            # class-indexed candidate PVs, one pass over the PV table
            # per CYCLE instead of one per (claim, node)
            classes = {c.storage_class_name or "" for c in pv.claims_to_bind}
            for p in client.list_pvs():
                if p.phase != "Available" or p.claim_ref is not None:
                    continue
                cls = p.storage_class_name
                if cls in classes:
                    pv.candidates.setdefault(cls, []).append(p)
            pv.node_independent = all(
                p.node_affinity is None
                for ps in pv.candidates.values() for p in ps
            )
        state.write(PRE_FILTER_STATE_KEY, pv)
        return None

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        if node_info.node is None:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node not found")
        try:
            pv_state: _PodVolumes = state.read(PRE_FILTER_STATE_KEY)
        except KeyError:
            return None
        node = node_info.node
        client = self.handle.client

        # bound claims: PV node affinity must admit this node
        for pvc in pv_state.bound_claims:
            pv = client.get_pv(pvc.volume_name)
            if pv is None or not node_matches_node_selector(node, pv.node_affinity):
                return Status(UNSCHEDULABLE, ERR_REASON_NODE_CONFLICT)

        # delayed-binding claims: find a matching available PV per claim
        if pv_state.claims_to_bind:
            if pv_state.node_independent and \
                    pv_state.cached_chosen is not None:
                # no candidate carries node affinity: the match from
                # the first filtered node holds for every node
                pv_state.matches[node.name] = pv_state.cached_chosen
                return None
            chosen: Dict[str, str] = {}
            used = set()
            for pvc in pv_state.claims_to_bind:
                match = self._find_matching_pv(pv_state, pvc, node, used)
                if match is not None:
                    chosen[f"{pvc.namespace}/{pvc.name}"] = match.name
                    used.add(match.name)
                else:
                    sc = client.get_storage_class(pvc.storage_class_name)
                    if sc is None or not sc.provisioner:
                        return Status(UNSCHEDULABLE, ERR_REASON_BIND_CONFLICT)
                    # dynamic provisioning will satisfy it on this node
            pv_state.matches[node.name] = chosen
            if pv_state.node_independent:
                pv_state.cached_chosen = chosen
        return None

    @staticmethod
    def _find_matching_pv(pv_state, pvc, node, used):
        request = pvc.requests.get("storage")
        for pv in pv_state.candidates.get(pvc.storage_class_name or "", ()):
            if pv.name in used:
                continue
            if pvc.access_modes and not set(pvc.access_modes) <= set(pv.access_modes):
                continue
            if request is not None:
                cap = pv.capacity.get("storage")
                if cap is None or cap < request:
                    continue
            if not node_matches_node_selector(node, pv.node_affinity):
                continue
            return pv
        return None

    # ------------------------------------------------------------------
    def reserve(self, state, pod: Pod, node_name: str) -> Optional[Status]:
        try:
            pv_state: _PodVolumes = state.read(PRE_FILTER_STATE_KEY)
        except KeyError:
            return None
        chosen = pv_state.matches.get(node_name, {})
        client = self.handle.client
        assumed = {}
        for pvc_key, pv_name in chosen.items():
            client.assume_pv_bound(pv_name, pvc_key)
            assumed[pv_name] = pvc_key
        self._assumed[pod.uid] = assumed
        return None

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        client = self.handle.client
        for pv_name in self._assumed.pop(pod.uid, {}):
            client.revert_assumed_pv(pv_name)

    def pre_bind(self, state, pod: Pod, node_name: str) -> Optional[Status]:
        client = self.handle.client
        for pv_name, pvc_key in self._assumed.pop(pod.uid, {}).items():
            ns, name = pvc_key.split("/", 1)
            ok = client.bind_pv(pv_name, ns, name)
            if not ok:
                return Status(1, f"binding PV {pv_name} to PVC {pvc_key} failed")
        return None
