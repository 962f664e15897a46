"""Share of the FSE_Compressed table descriptions the decode planner reads
(``plan._plan_frame``) that its native reader read (``native/seq_header.cpp``):
100 x the program's counters ``plan.fse_descs_native`` over
``plan.fse_descs``. The rest went through the verbatim Python reader, where
the library could not be built or a block was malformed."""

from portbench.ranges import counter_ratio


def read(ctx):
    share = counter_ratio(ctx, "decode", "plan.fse_descs_native", "plan.fse_descs")
    return None if share is None else 100 * share
