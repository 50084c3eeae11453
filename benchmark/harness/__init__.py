"""The benchmark's general machinery: finding a cell's files by name, the
request generator, the measured window, the profiler's reduction and the
result line. Nothing here knows a particular configuration, traffic mix or
metric: those are files under ``configs/``, ``traffic/``, ``metrics/``,
``systems/`` and ``circuits/``, found by the names in ``BENCHMARK.json``.
"""
