"""kofft_tpu_torch.bench: the benchmark harness (chained differential
timing on CUDA graphs, BenchRecord rows, the SNR tier policy and the JSON
history), the counterpart of ``kofft_tpu.bench``.
"""

from .harness import (timeit_chained, timeit_chained_scalar, BenchRecord,
                      last_measurement_mode, run_history,
                      SNR_POLICY_DB, check_snr_policy)  # noqa: F401
