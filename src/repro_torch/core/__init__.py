"""Hermes core, PyTorch port: the slice ported so far (dense continuous
batching).  Only what is ported is exported here."""
from repro_torch.core.engine import MODES, PipeloadEngine, RunStats  # noqa: F401
from repro_torch.core.hermes import Hermes  # noqa: F401
from repro_torch.core.planner import (GenPlanEntry, PlanEntry,  # noqa: F401
                                      plan, plan_generate)
from repro_torch.core.prefetch import (PrefetchFault,  # noqa: F401
                                       PrefetchRuntime, PrefetchStream)
from repro_torch.core.profiler import profile_model  # noqa: F401
from repro_torch.core.scheduler import (BatchScheduler, Request,  # noqa: F401
                                        ServeStats)
from repro_torch.core.telemetry import (MetricsRegistry,  # noqa: F401
                                        Telemetry, metrics)
