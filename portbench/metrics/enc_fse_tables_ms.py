"""Milliseconds of the program's range ``zk.enc.host_decisions.fse_tables``
(the FSE table choices, the third loop of ``archive._host_jobs``) less the
program's ranges inside it, per encode call, in the profiled stretch."""

from portbench.ranges import range_ms


def read(ctx):
    return range_ms(ctx, "encode", "enc.host_decisions.fse_tables", own=True)
