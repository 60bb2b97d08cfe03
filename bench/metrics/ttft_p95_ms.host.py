"""``ttft_p95_ms`` read in the traced run, where the card idles most of
the window and the tail follows the host: the 95th percentile over every
request sent in the window of its send to the end of the tick that
emitted its first token (to the window's end where it has none)."""
import stats


def read(rec):
    return 1e3 * stats.percentile(rec["ttft_s"], 95) if rec["ttft_s"] \
        else None
