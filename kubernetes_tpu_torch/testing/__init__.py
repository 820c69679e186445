"""Test builders (``MakePod``, ``MakeNode``) and fake plugins for the
port's harnesses and tests."""

from kubernetes_tpu_torch.testing.wrappers import (
    MakeNode,
    MakePod,
    NodeWrapper,
    PodWrapper,
)

__all__ = ["MakeNode", "MakePod", "NodeWrapper", "PodWrapper"]
