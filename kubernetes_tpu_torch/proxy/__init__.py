from kubernetes_tpu_torch.proxy.dataplane import VirtualDataplane
from kubernetes_tpu_torch.proxy.ipallocator import IPAllocator, IPAllocatorFull
from kubernetes_tpu_torch.proxy.ipvs import IpvsProxier
from kubernetes_tpu_torch.proxy.proxier import Proxier, Rule
