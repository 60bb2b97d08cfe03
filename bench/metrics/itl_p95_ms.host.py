"""``itl_p95_ms`` read in the traced run, where the card idles most of
the window and the tail follows the host: the 95th percentile over every
gap between consecutive tokens of one request inside the window, the open
gaps of running requests at its end included."""
import stats


def read(rec):
    return 1e3 * stats.percentile(rec["itl_s"], 95) if rec["itl_s"] \
        else None
