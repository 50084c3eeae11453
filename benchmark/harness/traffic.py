"""The one request generator: a traffic file's parameters -> the order in
which a client sends requests for the entries of its input pool.

A traffic file (``traffic/<mix>.json``) gives ``loop`` ("closed": a client
sends its next request when the last one has completed), ``clients`` (1),
``pool`` (how many distinct inputs the benchmark makes from the seed) and
``min_requests`` (the fewest a window completes, 1 unless given), beside
the operation's own shapes, which the system reads. Every seed sends the
same kind and number of inputs; the seed only draws the inputs and their
order.
"""

from __future__ import annotations

import random
from collections.abc import Iterator


def check(traffic: dict) -> None:
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"traffic {traffic}: only a closed loop of one client is generated")
    if int(traffic["pool"]) < 1:
        raise ValueError("traffic: pool must hold at least one input")


def request_order(traffic: dict, seed: int) -> Iterator[int]:
    """Pool indices in sending order: the pool in a seeded shuffle, shuffled
    anew each pass, never the same index twice in a row (a call that
    returned its last answer again must not look right)."""
    check(traffic)
    pool = int(traffic["pool"])
    rng = random.Random(f"traffic-order:{seed}")
    prev = None
    while True:
        order = list(range(pool))
        rng.shuffle(order)
        if pool > 1 and order[0] == prev:
            order[0], order[-1] = order[-1], order[0]
        yield from order
        prev = order[-1]


def derive_seed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose (a generator of inputs, a proof's
    blinding) drawn from the run's seed."""
    return random.Random(repr(("bench", seed) + purpose)).getrandbits(63)
