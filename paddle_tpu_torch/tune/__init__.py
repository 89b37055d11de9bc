"""Kernel autotuning: searched launch plans, persisted per device
(counterpart of paddle_tpu/tune).

The CUDA kernels' wrappers resolve their plan options at the first launch
of a shape through :func:`kernel_config`, which walks forced/env
overrides, then the JSON tuning cache (exact bucket, then nearest
same-dtype bucket), then the kernel's rule.  ``tools/perf/torch_autotune.py``
runs the sweep that fills the cache: timed launches in child processes on
the card, the H100 roofline model on the CPU.
"""
from .cache import (TuningCache, bucket_signature, cache_path, config_epoch,
                    current_cache, device_kind, kernel_config,
                    kernel_config_with_meta, provenance_snapshot,
                    reset_provenance, set_cache_path)
from .registry import (TunableKernel, all_kernels, candidate_configs,
                       defaults_for, get_kernel, register)
from .search import (CostModelMeasurer, SubprocessMeasurer, run_sweep,
                     sweep_kernel, untuned_launch_report)

__all__ = [
    "TuningCache", "bucket_signature", "cache_path", "config_epoch",
    "current_cache", "device_kind", "kernel_config",
    "kernel_config_with_meta", "provenance_snapshot", "reset_provenance",
    "set_cache_path",
    "TunableKernel", "all_kernels", "candidate_configs", "defaults_for",
    "get_kernel", "register",
    "CostModelMeasurer", "SubprocessMeasurer", "run_sweep", "sweep_kernel",
    "untuned_launch_report",
]
