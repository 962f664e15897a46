"""Bytes the decode planner slices out of the buffer it is handed (frame
header, block header and block slices, ``plan._plan_frame``) per compressed
byte it plans: the program's counters ``plan.copied_bytes`` over
``plan.planned_bytes``. A planner that slices each block once reads 1-2."""

from portbench.ranges import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "decode", "plan.copied_bytes", "plan.planned_bytes")
