"""Run-time utilities of the port: phase meters and profiler traces
(``profiling``), TensorBoard scalars (``tb``)."""
