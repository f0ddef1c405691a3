"""host_syncs_per_iter: synchronisations of the host with the device that
the program made (``torch.cuda.set_sync_debug_mode("warn")``), over the
IPM iterations."""

from portbench.readings import iters


def read(run):
    n = iters(run)
    if "host_syncs" not in run["counters"] or not n:
        return None
    return run["counters"]["host_syncs"] / n
