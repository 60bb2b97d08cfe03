"""Model FLOPs the window's work needs over the window's seconds at the
card's bf16 dense peak, in percent: 2 x layer weights a computed token,
the head where logits are computed, attention's 4 Dh heads a (query, key)
pair attended; tokens served from the prefix pool count nothing."""
import flops


def read(rec):
    sp = rec.get("spans")
    if not sp or not (sp["prefills"] or sp["decodes"]):
        return None
    run = rec["run"]
    work = sum(flops.prefill_flops(run, c, skip)
               for c, skip, _nq, _nkv in sp["prefills"])
    work += sum(flops.decode_flops(run, ls) for _, ls in sp["decodes"])
    return 100.0 * work / (rec["window_s"] * flops.PEAK_BF16_FLOPS)
