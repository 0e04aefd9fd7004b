"""The step's exchanges at the link's peak (splatbench/exchange_costs.py:
the bytes a rank must receive a step over 450 GB/s, NVLink 4 one way into
an H100 SXM) over `exchange.device_ms.train4`, in %."""

from splatbench import exchange_costs

UNIT, LAYER, MOVES, SOURCE = "%", "sharded render", "step_ms", "device_trace"


def read(r):
    ms, nbytes = r.get("exchange_ms"), r.get("exchange_bytes_per_step")
    if not ms or not nbytes:
        return None
    return 100.0 * (1e3 * nbytes / exchange_costs.NVLINK_BYTES_PER_S) / ms
