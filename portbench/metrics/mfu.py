"""mfu (%): one steady frame's operations at the traced live-edge count
(portbench/flops.py: both encoders, the update operator, K1, bundle
adjustment) times the traced run's frames/s, over the card's 989 TFLOP/s
(bf16 dense). The live-edge count is the mean over K1's calls in client
0's frames traced alone once the window has closed; the frames/s are
those all clients began per second from the release until the profiler
started, which the card's pace sets once the launch queues are full: the
profiler's own cost is left out."""
import statistics

from portbench.flops import BF16_FLOP_PER_S, frame_flops


def read(facts):
    t = facts['trace']
    k = t and t['solo']['spans'].get('k1')
    if not t or not t.get('fps_pre') or not k or not k.get('live'):
        return None
    fl = frame_flops(facts['config'], statistics.mean(k['live']))
    return 100.0 * fl * t['fps_pre'] / BF16_FLOP_PER_S
