"""Prefix-block lookups that found their content block over all lookups
(``prefix_block_hits / (hits + misses)`` of ``coherence_report()``'s
deltas over the window), in percent."""


def read(rec):
    c = rec["coherence"]
    n = c["prefix_block_hits"] + c["prefix_block_misses"]
    return 100.0 * c["prefix_block_hits"] / n if n else None
