"""busy_ms (ms/frame): the card's busy time in the common traced interval
(the union of all clients' device intervals) over the frames all clients
finished in it: the device time one frame costs at the cell's load,
context switches between the clients included."""


def read(facts):
    t = facts['trace']
    if not t or t['busy_s'] <= 0 or not t['frames_in']:
        return None
    return 1e3 * t['busy_s'] / t['frames_in']
