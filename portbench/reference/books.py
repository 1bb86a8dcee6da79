"""The runtime's integer bookkeeping, replayed on the host from its
keyframe decisions: keyframe timestamps, ring slots, the pair table, the
trajectory links of removed keyframes, and which input frame each ring
slot last received.

The runtime keeps these on the device and reads nothing back; the one
input that depends on floating point is each frame's keyframe decision,
which the caller gives (the keyframe count after every frame). Plain
Python lists, the same rules as the reference dpvo.py:377-473 on a
pair-blocked table.
"""
from __future__ import annotations


class Books:
    """State after the frames replayed so far (all frames accepted)."""

    def __init__(self, s):
        self.s = s
        self.n = 0
        self.counter = 0
        self.tstamps = []      # keyframe -> input frame
        self.fslot = []        # keyframe -> ring slot
        self.pairs = []        # valid (pi, pj), in table order
        self.delta_src = {}    # removed input frame -> its predecessor
        self.slot_frame = {}   # ring slot -> input frame written last

    @property
    def is_init(self):
        return self.counter >= 8

    def step(self, removed):
        """One frame; `removed`: whether its keyframe test removed a
        keyframe (only asked once initialized)."""
        s = self.s
        n, r = self.n, s['r']
        live_lo = max(0, n - (s['PCF'] + 2) + 1)
        used = {self.fslot[k] for k in range(live_lo, n)}
        slot = next((i for i in range(s['pmem']) if i not in used), 0)
        self.tstamps.append(self.counter)
        self.fslot.append(slot)
        self.slot_frame[slot] = self.counter
        was_init = self.is_init
        self.counter += 1
        n1 = n + 1
        new = [(i, n1 - 1) for i in range(n1 - r, n1 - 1)] + \
              [(n1 - 1, j) for j in range(n1 - r, n1)]
        new = [p for p in new if p[0] >= 0 and p[1] >= 0]
        self.pairs = self._compact(self.pairs + new[:s['GP'] - len(
            self.pairs)])
        self.n = n1
        if not was_init or not removed:
            if was_init:
                self._retire()
            return
        k = n1 - s['kf_index']
        self.delta_src[self.tstamps[k]] = self.tstamps[k - 1]
        self.pairs = [(i - (i > k), j - (j > k)) for i, j in self.pairs
                      if i != k and j != k]
        del self.tstamps[k], self.fslot[k]
        self.n = n1 - 1
        self._retire()

    def _retire(self):
        self.pairs = self._compact([p for p in self.pairs
                                    if p[0] >= self.n - self.s[
                                        'removal_window']])

    @staticmethod
    def _compact(pairs):
        return sorted(pairs, key=lambda p: p[1])     # stable, by target
