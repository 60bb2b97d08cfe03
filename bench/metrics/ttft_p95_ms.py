"""95th percentile over every request sent in the window of the time from
its send to the end of the tick that emitted its first token (to the
window's end where it has none)."""
import stats


def read(rec):
    return 1e3 * stats.percentile(rec["ttft_s"], 95) if rec["ttft_s"] \
        else None
