"""device_ops (ops/frame): kernels, copies and sets launched inside
DeviceVO.__call__ per frame, in client 0's frames traced alone once the
window has closed."""


def read(facts):
    t = facts['trace']
    f = t and t['solo']['spans'].get('frame')
    if not f or not f['calls'] or not f['ops']:
        return None
    return f['ops'] / f['calls']
