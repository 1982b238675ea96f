"""Host-side utilities: the TensorBoard scalar writer, tracing and
timing, and the reference's random streams (``utils.prng``)."""

from lisec_tpu_torch.utils.profiling import Timer, device_sync, trace
from lisec_tpu_torch.utils.tb_writer import (TensorBoardWriter,
                                             read_scalar_events)

__all__ = ["TensorBoardWriter", "Timer", "device_sync",
           "read_scalar_events", "trace"]
