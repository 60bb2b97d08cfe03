"""Streams decoded a step over the replica's ``max_batch``, mean over
every decode step of the window, in percent."""


def read(rec):
    steps = rec.get("spans", {}).get("decodes")
    if not steps:
        return None
    mb = rec["serving"]["max_batch"]
    return 100.0 * sum(len(ls) for _, ls in steps) / (mb * len(steps))
