"""K4 (``paged_decode``): its least time by the roofline (each live KV
row, q, the fresh k / v and the output moved once at the HBM bandwidth,
or its operations at the bf16 peak, whichever is longer) over its device
time in the traced window, in percent."""
import flops


def read(rec):
    pr = rec.get("profile")
    if not pr or not pr["k4_s"] or not pr["k4_work"][1]:
        return None
    return 100.0 * flops.least_seconds(*pr["k4_work"]) / pr["k4_s"]
