from repro_torch.models.api import UnsupportedFamilyError
from repro_torch.serve.chaos import Fault, FaultPlan, InjectedFault
from repro_torch.serve.engine import (Engine, EngineReference, PagedEngine,
                                      Request, engine_reference)
from repro_torch.serve.paged import (PagePool, PagePoolExhausted, RadixTree,
                                     pages_for)
from repro_torch.serve.resilience import (DONE, FAILED, PENDING, QUEUED,
                                          RUNNING, SHED, TERMINAL_STATES,
                                          TIMED_OUT, ShedPolicy,
                                          WatchdogError, WindowWatchdog)
from repro_torch.serve.telemetry import (Tracer, latency_summary,
                                         percentile, request_latency,
                                         summarize, validate_chrome_trace)
from repro_torch.serve.workload import (lognormal_lengths, mixed_requests,
                                        poisson_arrivals, poisson_requests,
                                        run_arrivals, run_staggered,
                                        shared_prefix_requests,
                                        staggered_groups)

__all__ = ["Engine", "EngineReference", "PagedEngine", "Request",
           "UnsupportedFamilyError", "engine_reference",
           "PagePool", "PagePoolExhausted", "RadixTree", "pages_for",
           "Fault", "FaultPlan", "InjectedFault",
           "DONE", "FAILED", "PENDING", "QUEUED", "RUNNING", "SHED",
           "TERMINAL_STATES", "TIMED_OUT",
           "ShedPolicy", "WatchdogError", "WindowWatchdog",
           "Tracer", "latency_summary", "percentile", "request_latency",
           "summarize", "validate_chrome_trace",
           "lognormal_lengths", "mixed_requests", "poisson_arrivals",
           "poisson_requests", "run_arrivals", "run_staggered",
           "shared_prefix_requests", "staggered_groups"]
