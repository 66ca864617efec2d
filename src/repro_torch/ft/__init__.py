from repro_torch.ft.monitor import HeartbeatMonitor, StragglerPolicy  # noqa: F401
from repro_torch.ft.elastic import ElasticPlan, plan_elastic_restart  # noqa: F401
