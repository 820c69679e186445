from kubernetes_tpu_torch.kubemark.hollow import HollowCluster, HollowFleet, HollowNode
