"""The port's observability: the span tracer and flight recorder
(``tracer``), per-solve-cycle device profiling (``devprof``), the SLO
engine (``slo``) and critical-path attribution over tracer rings
(``fleettrace``)."""

from kubernetes_tpu_torch.observability.tracer import (
    TRACE_HEADER,
    Span,
    TraceContext,
    Tracer,
    format_trace_header,
    get_tracer,
    parse_trace_header,
    set_tracer,
)

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer", "TRACE_HEADER",
           "TraceContext", "format_trace_header", "parse_trace_header",
           "get_slo_engine", "set_slo_engine"]


def get_slo_engine():
    from kubernetes_tpu_torch.observability.slo import get_slo_engine as _g

    return _g()


def set_slo_engine(engine):
    from kubernetes_tpu_torch.observability.slo import set_slo_engine as _s

    return _s(engine)
