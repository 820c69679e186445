from kubernetes_tpu_torch.kubelet.checkpoint import CheckpointManager, CorruptCheckpointError
from kubernetes_tpu_torch.kubelet.cri import (
    CREATED,
    EXITED,
    FakeRuntime,
    ImageService,
    RuntimeService,
)
from kubernetes_tpu_torch.kubelet.devicemanager import (
    DeviceAllocationError,
    DeviceManager,
    DevicePlugin,
    TPU_RESOURCE,
)
from kubernetes_tpu_torch.kubelet.kubelet import Kubelet
from kubernetes_tpu_torch.kubelet.volumemanager import VolumeManager
from kubernetes_tpu_torch.kubelet.probes import LIVENESS, READINESS, ProbeManager, ProbeSpec
