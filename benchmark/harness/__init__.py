"""The benchmark's general parts: the cell's loops, the profiler's reading,
the peaks table and the comparisons. Whatever belongs to one configuration,
traffic mix or per-layer metric lives in a file of its own, found by the
name that ``BENCHMARK.json`` gives it."""
