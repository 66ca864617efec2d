from repro_torch.kernels.schedule import schedule_key  # noqa: F401
from repro_torch.serving.batcher import (  # noqa: F401
    KeyStats,
    MicroBatcher,
    QueueFullError,
    Request,
)
from repro_torch.serving.compile_cache import (  # noqa: F401
    ArgSpec,
    CachedExecutor,
    CompileCache,
    KeyCompileStats,
)
from repro_torch.serving.engine import (  # noqa: F401
    EngineClosedError,
    RNNServingEngine,
    format_serve_report,
)
from repro_torch.serving.faults import (  # noqa: F401
    FaultInjector,
    InjectedFault,
    ReplicaCrashed,
    ReplicaFaultSet,
    VirtualClock,
    break_engine_key,
    corrupt_cache_entries,
    crash_replica,
    flapping,
    slow_replica,
)
from repro_torch.serving.lm_engine import LMServingEngine  # noqa: F401
from repro_torch.serving.replica import (  # noqa: F401
    EngineReplica,
    ReplicaPool,
)
from repro_torch.serving.router import (  # noqa: F401
    HashRing,
    ReplicaTimeout,
    RoutedRequest,
    Router,
    RouterPolicy,
    format_router_report,
)
from repro_torch.serving.speculative import (  # noqa: F401
    CacheTable,
    RowAdvance,
    SpecConfig,
    SpeculativeDecoder,
    accept_chunk,
    speculative_generate,
)
from repro_torch.serving.streaming import (  # noqa: F401
    SHED_REASONS,
    STAGES,
    StreamingPipeline,
    StreamRequest,
    TokenBucket,
    format_stream_report,
)
