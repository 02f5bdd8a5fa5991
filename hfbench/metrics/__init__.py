"""Per-layer metric readers, one file each, found by the metric's name.

Each file defines ``read(run)``: the metric's value from a finished run
(``harness.RunResult``: its passes' stage seconds and counters, and the
trace's summary where the run was traced), or None where it finds
nothing to read, and then the harness leaves the metric out.
"""
