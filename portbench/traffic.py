"""The one generator of the benchmark's traffic.

A traffic file names how many of the configuration's instances a run
solves (``instances``: the first of its ``seeds``, the upstream
configuration's own), how many iterations the warm-up takes
(``warmup_max_iter``) and the program's whole-solve switch
(``whole_solve``).  The run's ``--seed`` sets the order in which the
instances are solved, so every seed gives the same set of instances, in
another order.  Each instance is
drawn from numpy's ``RandomState`` seeded with its upstream seed, and its
solve goes on with the same stream, as the program's runner solves that
seed: every solve of the instance, in every run, is the same solve.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["schedule"]


def schedule(config: dict, traffic: dict, seed: int) -> List[int]:
    """The upstream seeds of one round's instances, in the order ``seed``
    gives them."""
    seeds = [int(s) for s in config["seeds"]][: int(traffic["instances"])]
    if len(seeds) < int(traffic["instances"]):
        raise ValueError(f"the configuration has {len(seeds)} seeds, the traffic asks for "
                         f"{traffic['instances']}")
    order = np.random.default_rng(np.random.SeedSequence(int(seed) % 2**64)).permutation(
        len(seeds))
    return [seeds[i] for i in order]
