from repro_torch.kernels.schedule import schedule_key  # noqa: F401
from repro_torch.serving.batcher import (  # noqa: F401
    KeyStats,
    MicroBatcher,
    QueueFullError,
    Request,
)
from repro_torch.serving.engine import (  # noqa: F401
    EngineClosedError,
    RNNServingEngine,
    format_serve_report,
)
from repro_torch.serving.lm_engine import LMServingEngine  # noqa: F401
