"""The benchmark of ``neusky_torch``: one run of one cell a process.

Run from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are data: ``workloads/<cell>.json``
names its configuration (``configs/<name>.json``), its traffic and its
window loop (``loops/<loop>.py``); every metric is read by
``metrics/<metric>.py``.  ``reference/`` holds the plain reference that
decides ``correct``; it imports nothing of the program.
"""
