"""Host milliseconds inside ``LeaseEngine.read_many`` and ``write_many``
(admission waves and decode renewals) per scheduler tick."""


def read(rec):
    lease = rec.get("spans", {}).get("lease_s")
    if lease is None or not rec["ticks"]:
        return None
    return 1e3 * sum(lease) / rec["ticks"]
