"""Fake plugins for framework tests, as the reference's
``pkg/scheduler/testing/fake_plugins.go`` has them: filters that always
pass, always fail, or pass only the node named as the pod; a score from
a function; a Reserve that records (or rejects); a Permit with a fixed
verdict."""

from __future__ import annotations

from kubernetes_tpu_torch.scheduler.framework import interface as fw


class TrueFilter(fw.FilterPlugin):
    NAME = "TrueFilter"

    @staticmethod
    def factory(args, handle):
        return TrueFilter()

    def filter(self, state, pod, node_info):
        return None


class FalseFilter(fw.FilterPlugin):
    NAME = "FalseFilter"

    @staticmethod
    def factory(args, handle):
        return FalseFilter()

    def filter(self, state, pod, node_info):
        return fw.Status(fw.UNSCHEDULABLE, "injected filter failure")


class MatchFilter(fw.FilterPlugin):
    """Passes only when the node name equals the pod name."""

    NAME = "MatchFilter"

    @staticmethod
    def factory(args, handle):
        return MatchFilter()

    def filter(self, state, pod, node_info):
        if node_info.node is not None and node_info.node.name == pod.name:
            return None
        return fw.Status(fw.UNSCHEDULABLE, "node didn't match pod name")


class FakeScore(fw.ScorePlugin):
    NAME = "FakeScore"

    def __init__(self, score_fn):
        self.score_fn = score_fn

    def score(self, state, pod, node_name):
        return self.score_fn(pod, node_name), None


class RecordingReserve(fw.ReservePlugin):
    NAME = "RecordingReserve"

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.reserved = []
        self.unreserved = []

    def reserve(self, state, pod, node_name):
        if self.fail:
            return fw.Status(fw.UNSCHEDULABLE, "reserve rejected")
        self.reserved.append((pod.name, node_name))
        return None

    def unreserve(self, state, pod, node_name):
        self.unreserved.append((pod.name, node_name))


class FakePermit(fw.PermitPlugin):
    NAME = "FakePermit"

    def __init__(self, code=fw.SUCCESS, timeout: float = 1.0):
        self.code = code
        self.timeout = timeout

    def permit(self, state, pod, node_name):
        if self.code == fw.SUCCESS:
            return None, 0.0
        return fw.Status(self.code, "fake permit"), self.timeout
