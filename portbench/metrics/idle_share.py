"""idle_share (%): the share of the common traced interval in which no
client's device operation ran (the complement of the union of all
clients' device intervals, aligned on the host's monotonic clock)."""


def read(facts):
    t = facts['trace']
    if not t or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['interval_s'])
