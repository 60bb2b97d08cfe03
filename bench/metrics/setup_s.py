"""Seconds from the process's start to the window's start: loading,
weights drawn on the card, the pool, the untimed warm-up ticks."""


def read(rec):
    return rec["setup_s"]
