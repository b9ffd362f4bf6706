"""Execution substrate of the port: bucketing, prefetch, fusion and the CUDA
kernels (``perf.kernels``, also the kernel-selection layer), and the
performance tier: ``compile_watch`` (dispatch and first-seen-shape
counters), ``planner`` (``plan_memory`` under a device-memory budget) and
``autotune`` (``TuningRecord``)."""
