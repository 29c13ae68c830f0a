"""Profiling and checkpoints. Counterpart of diffdart_tpu/utils/."""
from diffdart_tpu_torch.utils.profile import Stopwatch, PerformanceLog, MetricsLogger  # noqa: F401
from diffdart_tpu_torch.utils.checkpoint import save_checkpoint, restore_checkpoint  # noqa: F401
