"""enqueue_ms (ms/frame): the median over all clients' frames outside the
traced interval of the host clock around DeviceVO.__call__, with no
synchronize: the driver's host work, and once the card is saturated the
waits on a full launch queue."""
import statistics


def read(facts):
    t = facts['trace']
    if not t or not t['enqueue_s']:
        return None
    return 1e3 * statistics.median(t['enqueue_s'])
