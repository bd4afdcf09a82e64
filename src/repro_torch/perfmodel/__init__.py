from repro_torch.perfmodel.calibrate import (  # noqa: F401
    BENCH_FILE, CALIBRATION_FILE, IDENTITY, Calibration, calibration_from_bench,
    calibration_from_file, refresh_calibration_file)
from repro_torch.perfmodel.hw import CPU_XEON, HW, PLASTICINE, TPU_V5E  # noqa: F401
from repro_torch.perfmodel.model import (  # noqa: F401
    Breakdown, binary_cascade_time, cpu_cascade_time, linear3_time,
    star3_binary_time, star3_time)
