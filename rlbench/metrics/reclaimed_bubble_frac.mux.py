"""The share of the back-to-back bubble that co-execution reclaimed over
the window: the pools' busy seconds less the union of their busy
intervals, over the busy seconds less the busiest pool's (the runtime's
per-pool timelines, the harness's own arithmetic)."""


def read(obs):
    return obs.get("reclaimed")
