"""Serving subsystem of the port: batched inference over trained models.

``engine``   the :class:`Engine` protocol (``warmup``/``infer``/
             ``signature``) with four implementations — the FEM-surrogate
             forward pass, the parallel-in-time trajectory surrogate, LM
             decode (prefill through the flash kernel, resident or
             host-offloaded KV), and a batch-axis sharding wrapper over the
             one-device case mesh.
``batcher``  request microbatching: bounded queue, max-batch / max-wait
             flush, deadlines, split-retry isolation, non-finite output
             check, circuit breaker, per-request latency accounting.
``cache``    LRU result cache keyed by (engine signature, request key) —
             repeated hazard lookups never touch the device.
``feedback`` the active-learning loop: high-uncertainty requests become
             scenario records the planner groups into new sweep jobs.
``decode``   engine-internal decode loop (Algorithm 3 applied to serving);
             production callers use :class:`DecodeEngine`.
"""
from repro_torch.serving.batcher import MicroBatcher, Request, ServedResult  # noqa: F401
from repro_torch.serving.cache import ResultCache  # noqa: F401
from repro_torch.serving.decode import ServeConfig  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    DecodeEngine, Engine, InferResult, ShardedEngine, SurrogateEngine,
    TrajectoryEngine,
)
from repro_torch.serving.feedback import (  # noqa: F401
    FeedbackLog, feedback_plan, load_feedback, scenario_to_dict,
)
