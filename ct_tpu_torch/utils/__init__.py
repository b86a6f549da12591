"""Small utilities of the port: device timing (``timing.py``),
profiling (``profiler.py``), the rank-aware logger (``logger.py``) and
the eval's tic/toc ``Timer`` (``timer.py``)."""
