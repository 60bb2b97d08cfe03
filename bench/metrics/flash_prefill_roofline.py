"""K6 (``flash_prefill``): its least time by the roofline (the causal
(query, key) pairs of each call's queries over its keys at the bf16 peak,
or q, k, v and the output moved once, whichever is longer) over its
device time in the traced window, in percent."""
import flops


def read(rec):
    pr = rec.get("profile")
    if not pr or not pr["k6_s"] or not pr["k6_work"][0]:
        return None
    return 100.0 * flops.least_seconds(*pr["k6_work"]) / pr["k6_s"]
