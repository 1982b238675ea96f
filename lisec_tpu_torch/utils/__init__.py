"""Host-side utilities: the TensorBoard scalar writer, tracing and the
program's spans, and the reference's random streams (``utils.prng``)."""

from lisec_tpu_torch.utils.profiling import clear_spans, span, spans, trace
from lisec_tpu_torch.utils.tb_writer import (TensorBoardWriter,
                                             read_scalar_events)

__all__ = ["TensorBoardWriter", "clear_spans", "read_scalar_events", "span",
           "spans", "trace"]
