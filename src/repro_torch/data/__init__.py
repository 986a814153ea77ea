"""Serving workloads for the port: the seeded multi-tenant traces."""
from repro_torch.data.traces import (TraceRequest, load_trace,  # noqa: F401
                                     make_trace, save_trace, submit_trace,
                                     tenant_prefix, trace_max_len)
