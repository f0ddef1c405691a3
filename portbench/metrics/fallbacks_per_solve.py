"""fallbacks_per_solve: calls of the ragged AMEn fallback
(``ipm.tt_restarted_block_amen``) a solve; 0 is a reading."""

def read(run):
    if "fallbacks" not in run["counters"] or not run["solves"]:
        return None
    return run["counters"]["fallbacks"] / len(run["solves"])
