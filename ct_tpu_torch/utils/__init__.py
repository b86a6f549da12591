"""Small utilities of the port: device timing (``timing.py``) and
profiling (``profiler.py``)."""
