"""fps (frames/s): every frame all clients submitted in the window, over
the time from the release to the last client's final synchronize."""


def read(facts):
    return facts['frames'] / facts['elapsed_s'] if facts['frames'] else None
