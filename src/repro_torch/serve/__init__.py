"""Serving: continuous-batching pool engine over a paged KV cache, and
the lockstep baseline."""
from repro_torch.serve.engine import (  # noqa: F401
    PoolEngine,
    ServeStats,
    generate,
    lockstep_generate,
)
from repro_torch.serve.scheduler import FIFOScheduler, Request  # noqa: F401
from repro_torch.serve.spec import LowBitSelfDraft, NgramDrafter  # noqa: F401
from repro_torch.serve.trace import poisson_trace, shared_prefix_trace  # noqa: F401
