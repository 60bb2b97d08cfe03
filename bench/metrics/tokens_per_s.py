"""Output tokens emitted in the window, finished requests or not, over
the window's seconds."""


def read(rec):
    return rec["tokens"] / rec["window_s"]
