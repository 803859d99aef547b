"""Decisions of the ``distdgl`` variant (DistDGL without prefetching):
there is no buffer, so no decision is asked."""


def make(traffic: dict, num_pes: int, agent: dict | None = None, seed: int = 0):
    return None
