"""patchify_ms (ms/frame): device time of the kernels launched inside the
`patchify` span (spans/patchify.json) per frame, both encoders and the patch gather, in client 0's
frames traced alone once the window has closed: no other context shares
the card then, so a kernel's time is its own and not the time slicer's."""


def read(facts):
    t = facts['trace']
    s = t and t['solo']['spans']
    if not s or not s.get('frame', {}).get('calls') or \
            not s.get('patchify', {}).get('device_s'):
        return None
    return 1e3 * s['patchify']['device_s'] / s['frame']['calls']
