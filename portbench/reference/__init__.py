"""The plain reference: a Zstandard decoder and seek-table parser of its own
(``zstd_plain``) and the comparison that decides ``correct`` (``judge``).
Nothing here imports the program under test."""
