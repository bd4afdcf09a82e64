from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    RestartableLoop, StragglerMonitor, elastic_restore)
