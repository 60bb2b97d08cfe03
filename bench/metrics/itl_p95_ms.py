"""95th percentile over every gap between consecutive tokens of one
request inside the window, the open gaps of running requests at its end
included."""
import stats


def read(rec):
    return 1e3 * stats.percentile(rec["itl_s"], 95) if rec["itl_s"] \
        else None
