from repro_torch.models.api import UnsupportedFamilyError
from repro_torch.serve.engine import (Engine, EngineReference, PagedEngine,
                                      Request)
from repro_torch.serve.paged import (PagePool, PagePoolExhausted, RadixTree,
                                     pages_for)
from repro_torch.serve.resilience import (DONE, FAILED, PENDING, QUEUED,
                                          RUNNING, SHED, TERMINAL_STATES,
                                          ShedPolicy)
from repro_torch.serve.telemetry import (latency_summary, percentile,
                                         request_latency, summarize)
from repro_torch.serve.workload import (mixed_requests, run_staggered,
                                        shared_prefix_requests,
                                        staggered_groups)

__all__ = ["Engine", "EngineReference", "PagedEngine", "Request",
           "UnsupportedFamilyError",
           "PagePool", "PagePoolExhausted", "RadixTree", "pages_for",
           "DONE", "FAILED", "PENDING", "QUEUED", "RUNNING", "SHED",
           "TERMINAL_STATES", "ShedPolicy",
           "latency_summary", "percentile", "request_latency", "summarize",
           "mixed_requests", "run_staggered", "shared_prefix_requests",
           "staggered_groups"]
