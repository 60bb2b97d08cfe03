"""Share of the traced window's wall time in which no operation ran on
the card (1 - the union of its activity intervals), in percent: the
traced run profiles its whole window."""


def read(rec):
    pr = rec.get("profile")
    if not pr or not pr["busy_s"]:
        return None
    return 100.0 * (1.0 - pr["busy_s"] / pr["slice_s"])
