"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), which a kernel's least time is
counted against.

The integer issue rate is read from the card: an SM of compute capability
9.0 issues one warp instruction per clock in each of its 4 partitions,
128 thread instructions per clock whatever pipe runs them, times the SMs
torch reports and the maximum SM clock nvidia-smi reports.
"""

PEAK_BYTES_S = 3.35e12          # HBM3
PEAK_F32_OPS_S = 67e12          # float32 outside the tensor cores
ISSUE_PER_SM_CLOCK = 128


def issue_per_s(sms: int, max_sm_clock_mhz: float) -> float:
    return sms * ISSUE_PER_SM_CLOCK * max_sm_clock_mhz * 1e6


def least_seconds(work: dict, issue_rate: float) -> float:
    """The least time of a work item {"flops", "int_ops", "bytes"}: its
    bytes at the memory rate, or its float operations at the float32 rate
    or its integer instructions at the issue rate, whichever is longest
    (the two operation terms run on separate pipes, so the longer of them
    bounds, not their sum)."""
    t_bytes = work["bytes"] / PEAK_BYTES_S
    t_ops = max(work["flops"] / PEAK_F32_OPS_S,
                work["int_ops"] / issue_rate)
    return max(t_bytes, t_ops)
