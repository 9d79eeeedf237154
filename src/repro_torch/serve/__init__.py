from repro_torch.models.api import UnsupportedFamilyError
from repro_torch.serve.engine import Engine, EngineReference, Request
from repro_torch.serve.resilience import (DONE, FAILED, PENDING, QUEUED,
                                          RUNNING, TERMINAL_STATES)
from repro_torch.serve.telemetry import (latency_summary, percentile,
                                         request_latency, summarize)
from repro_torch.serve.workload import (mixed_requests, run_staggered,
                                        staggered_groups)

__all__ = ["Engine", "EngineReference", "Request", "UnsupportedFamilyError",
           "DONE", "FAILED", "PENDING", "QUEUED", "RUNNING",
           "TERMINAL_STATES",
           "latency_summary", "percentile", "request_latency", "summarize",
           "mixed_requests", "run_staggered", "staggered_groups"]
