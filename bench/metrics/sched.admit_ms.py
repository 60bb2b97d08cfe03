"""Host milliseconds inside ``ServingCluster._admit`` (the lease wave, the
prefills, the page tables) per request it admitted."""


def read(rec):
    admits = rec.get("spans", {}).get("admits")
    n = sum(k for _, k in admits or ())
    return 1e3 * sum(dt for dt, k in admits if k) / n if n else None
