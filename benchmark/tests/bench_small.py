"""The traffic of a test run: a size the CPU holds, every column
checked."""

SMALL = dict(ncol=16, block=8, pool_calls=2, check_calls=2,
             check_columns=16, trace_calls=2)
