"""Host-side utilities: the TensorBoard scalar writer."""

from lisec_tpu_torch.utils.tb_writer import (TensorBoardWriter,
                                             read_scalar_events)

__all__ = ["TensorBoardWriter", "read_scalar_events"]
