"""Prompt tokens served from leased pool blocks (skipped by the admission
prefill) over all prompt tokens admitted in the window, in percent.  Only
the leading run of a prompt's blocks that hit, are valid and carry the
current weight version is served; a block that hits after a miss is
counted by ``lease.hit_share`` and recomputed all the same."""


def read(rec):
    pre = rec.get("spans", {}).get("prefills")
    total = sum(c + skip for c, skip, _nq, _nkv in pre or ())
    return 100.0 * sum(skip for _c, skip, _nq, _nkv in pre) / total \
        if total else None
