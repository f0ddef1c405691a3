"""setup_s: from the start of the process to the start of the window:
imports, the kernels built or loaded, the instances drawn and handed over,
the warm-up (host clock)."""

def read(run):
    return run["setup_s"]
