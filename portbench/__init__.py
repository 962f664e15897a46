"""The benchmark of ``zeekstd_tpu_torch``, the seekable-Zstandard archive
codec on an NVIDIA card.

Run one cell from the root of a checkout::

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names every cell, configuration and metric;
the harness finds each piece by that name: ``configs/<config>.json``,
``traffic/<mix>.json`` (with the loop ``kinds/<kind>.py`` it names),
``data/<generator>.py``, ``metrics/<metric>.py``. ``reference/`` judges
what the program wrote and read back, and imports nothing of it.
"""
