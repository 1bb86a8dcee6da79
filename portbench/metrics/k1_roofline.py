"""k1_roofline (%): K1's least time (bounds/k1.py, from each traced call's
own inputs) over its device time, summed over the calls of client 0's
frames traced alone once the window has closed (no other context
preempts K1 there)."""


def read(facts):
    t = facts['trace']
    k = t and t['solo']['spans'].get('k1')
    if not k or not k.get('bound_calls') or k['bound_device_s'] <= 0:
        return None
    return 100.0 * k['bound_s'] / k['bound_device_s']
